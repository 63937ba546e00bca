"""Kernel A's gstack selection (``selection="gstack"`` and ``"gpop"``, k <=
128): a step model of its walk, its depth, its routing, and the port
against the JAX package's gstack and gpop selections.

Kernel A cannot run here.  The model below repeats the walk of
``csrc/fused_topk.cu``'s ``gstack_tile`` / ``gstack_finish`` in NumPy, one
query row and split at a time: the row's 64 cells (the columns of the
64-column tile), each the best ``gstack_levels(k, tm)`` keys of its
column across the split, sorted; the row's bound (the k-th best entry of
levels 0 .. (k - 1) // 64 of its cells, raised after a tile in which the
row put any), which a score must beat (strict >) before its cell's
deepest entry;
then k pops of the best cell head, the row firing when a pop takes a
cell's deepest entry.  It must give ``fused_topk_partial_plain``'s split
lists bit for bit wherever the row does not fire, and
``gstack_partial_plain`` (the package's plain version of the walk, which
``chip_smoke.py`` holds the card's fire counter to) everywhere: on seeded
random scores, integer tie data, zero query rows, masked rows and wholly
masked splits, corpus rows and queries holding NaN and +-inf, and tile
lists.  Data that puts more than a cell's depth of a row's top-k in one
column must fire, and the launch's result (the exact re-walk's) stays
exact.

Then the depth (``gstack_levels`` against the union bound written out with
``math.comb``, and the source's constants), the routing (``gstack_built``,
``gstack_route``; ``check_selection`` is the JAX package's, unchanged), the
CPU launch (the plain version), and the same seeded NumPy inputs through
the JAX package with ``SearchConfig(selection="gstack")`` or ``"gpop"``
(its Pallas kernel in interpret mode, as its own tests run it) and
through the port's ``fused_topk``, ``Corpus.topk`` and ``ClusteredCorpus``
on the CPU with the same config: dense, probed, and segmented (more than
128 groups of 128 rows).  The JAX gstack packs a group id into each
score's low mantissa bits, truncating scores by up to 127 ulps, so scores
agree within its own tests' tolerance (rtol 3e-5, atol 2e-5; the
clustered handles 1e-4 / 5e-4, as ``test_torch_clustered.py``), indices
differing only on scores tied within it (the documented gstack exception
for duplicate scores across segments).
"""

from __future__ import annotations

import importlib
import math
import re
from pathlib import Path

import jax.numpy as jnp
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

SRC = (Path(F.__file__).parent / "csrc" / "fused_topk.cu").read_text()
INT32_MAX = 2 ** 31 - 1
NEG_INF = np.float32(-np.inf)
CELLS = 64
# The JAX gstack's packing truncation (its own tests' tolerance).
TOL = dict(rtol=3e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# The step model.
# ---------------------------------------------------------------------------


def _key(v, i):
    """A (value desc, index asc) sort key, -0.0 as +0.0."""
    return (-float(v) if v != 0 else 0.0, int(i))


def gstack_row(row, k, levels):
    """One query row's split: ``row`` its scores (float32, a multiple of
    64 of them, NaN kept).  Returns (the k (value, index) pairs the pop
    finish writes, fired, tiles in which the row put any)."""
    cells = [[] for _ in range(CELLS)]   # each best first, at most levels
    lvl = (k - 1) // CELLS
    bound, puts = NEG_INF, 0
    for n0 in range(0, row.shape[0], CELLS):
        put = False
        for col in range(CELLS):
            s = row[n0 + col]
            with np.errstate(invalid="ignore"):
                if not s > bound:   # NaN and -inf never pass
                    continue
            cell = cells[col]
            if len(cell) == levels and _key(s, n0 + col) > _key(*cell[-1]):
                continue   # does not beat the deepest entry
            cell.append((s, n0 + col))
            cell.sort(key=lambda e: _key(*e))
            del cell[levels:]
            put = True
        if put:
            puts += 1
            top = sorted((e for cell in cells for e in cell[:lvl + 1]),
                         key=lambda e: _key(*e))
            bound = top[k - 1][0] if len(top) >= k else NEG_INF
    heads = [0] * CELLS
    out, fired = [], False
    for _ in range(k):
        live = [c for c in range(CELLS) if heads[c] < len(cells[c])]
        if not live:
            break
        c = min(live, key=lambda c: _key(*cells[c][heads[c]]))
        out.append(cells[c][heads[c]])
        fired |= heads[c] == levels - 1
        heads[c] += 1
    return out + [(NEG_INF, INT32_MAX)] * (k - len(out)), fired, puts


def gstack_partial(scores, k, splits, tps, tm):
    """The model over every row and split: (m, splits, k) values and
    global indices, (m, splits) fired."""
    m = scores.shape[0]
    rows = tps * 64
    pad = np.full((m, splits * rows), NEG_INF, np.float32)
    pad[:, :scores.shape[1]] = scores
    levels = F.gstack_levels(k, tm)
    v = np.empty((m, splits, k), np.float32)
    i = np.empty((m, splits, k), np.int32)
    fired = np.zeros((m, splits), bool)
    for r in range(m):
        for s in range(splits):
            out, fired[r, s], _ = gstack_row(pad[r, s * rows:(s + 1) * rows],
                                             k, levels)
            v[r, s] = [e[0] for e in out]
            i[r, s] = [e[1] + s * rows if e[1] != INT32_MAX else INT32_MAX
                       for e in out]
    return v, i, fired


# ---------------------------------------------------------------------------
# Operands and the model against the plain versions.
# ---------------------------------------------------------------------------


def _raw_scores(qp, cp, cbp, mask, precision):
    """The epilogue's scores as kernel A holds them: NaN kept (its strict
    > drops it), masked and past-the-end rows -inf."""
    d = F._plain_scores(qp, cp, precision)
    s = d * cbp[0] + cbp[1] if precision in F._QUANT else d + cbp
    if mask is not None:
        s = torch.where(mask.to(torch.bool), s, torch.full_like(s, NEG_INF))
    return s.numpy()


def _operands(kind, m, n, dim, seed, precision):
    r = np.random.default_rng(seed)
    metric = "cosine" if kind in ("random", "nonfinite") else "dot"
    if metric == "dot":   # integer entries, every corpus row twinned
        q = r.integers(-2, 3, (m, dim)).astype(np.float32)
        c = r.integers(-2, 3, (n, dim)).astype(np.float32)
        c[n // 2:] = c[: n - n // 2]
    else:
        q = r.standard_normal((m, dim)).astype(np.float32)
        c = r.standard_normal((n, dim)).astype(np.float32)
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


def _same_bits(v, i, want_v, want_i, where=None):
    v, i = np.asarray(v), np.asarray(i)
    want_v, want_i = np.asarray(want_v), np.asarray(want_i)
    if where is not None:
        v, i, want_v, want_i = v[where], i[where], want_v[where], want_i[where]
    np.testing.assert_array_equal(v.view(np.int32), want_v.view(np.int32))
    np.testing.assert_array_equal(i, want_i)


def _check(kind, k, tm, splits, tps, n, precision="highest", m=3, dim=8,
           seed=None):
    """The model against the plain versions; returns (m, splits) fired."""
    qp, cp, cbp, mask = _operands(kind, m, n, dim,
                                  seed=k + tm + n if seed is None else seed,
                                  precision=precision)
    want_v, want_i = F.fused_topk_partial_plain(qp, cp, cbp, mask, k,
                                                precision, splits, tps)
    v, i, fired = gstack_partial(_raw_scores(qp, cp, cbp, mask, precision),
                                 k, splits, tps, tm)
    _same_bits(v, i, want_v, want_i, ~fired)
    pv, pi, pf = F.gstack_partial_plain(qp, cp, cbp, mask, k, precision,
                                        splits, tps, tm)
    _same_bits(pv, pi, v, i)
    np.testing.assert_array_equal(pf.numpy(), fired)
    # The launch (its re-walk included) is the plain version everywhere.
    got_v, got_i = F.fused_topk_partial(qp, cp, cbp, mask, k, precision,
                                        splits, tps, tm, gstack=True)
    _same_bits(got_v, got_i, want_v, want_i)
    return fired


@pytest.mark.parametrize("tm", (16, 64))
@pytest.mark.parametrize("k", (1, 2, 5, 10, 16, 40, 100))
def test_walk_equals_the_plain_version(k, tm):
    """Seeded random scores and integer tie data: splits of one tile, of 3
    and of 17; k from one level below the bound's to 100 (two levels of
    cells under the bound)."""
    for kind, precision in (("random", "highest"), ("ties", "bf16x3")):
        _check(kind, k, tm, splits=30, tps=1, n=1900, precision=precision)
        _check(kind, k, tm, splits=10, tps=3, n=1900, precision=precision)
        _check(kind, k, tm, splits=2, tps=17, n=2100, precision=precision)


@pytest.mark.parametrize("k", (3, 10, 16, 70))
@pytest.mark.parametrize("kind", ["zero", "masked", "nonfinite"])
def test_walk_on_zero_rows_masks_and_nonfinite_values(kind, k):
    """All-tied zero query rows, masked rows and wholly masked splits,
    corpus rows and queries holding NaN and +-inf (a NaN score never
    passes; a query's NaN row fills nothing and never fires)."""
    for tm, precision in ((16, "highest"), (32, "bf16x3"), (16, "int8c")):
        fired = _check(kind, k, tm, splits=4, tps=6, n=1400,
                       precision=precision, m=6)
        if kind == "nonfinite":
            assert not fired[1].any() and not fired[3 % 6].any()


def _planted(k, hot, n=4096, d=16, spread=1):
    """The JAX package's planted collision: ``hot`` winners of one row,
    all in column 5 of their tiles (rows 5 + 64 j), over tiles of several
    splits, above a corpus of small random rows; the other rows of column
    5 score far below them all, so the column's cell holds the hot rows
    and then losers."""
    rng = np.random.default_rng(32 + k)
    c = rng.standard_normal((n, d)).astype(np.float32) * 1e-3
    c[5::64] = -1.0
    q = np.ones((1, d), dtype=np.float32)
    rows = 5 + 64 * spread * np.arange(hot)
    c[rows] = (q[0] / np.linalg.norm(q[0])) * (2.0 + np.arange(hot))[:, None]
    return q, c, rows


@pytest.mark.parametrize("k", (5, 10, 16, 100))
def test_planted_collision_fires_and_stays_exact(k):
    """More winners in one column than its cell holds: the detector fires
    on that row's split, the model and the plain version of the walk
    agree on it, and the launch's result (the exact re-walk's) is
    exact; with one winner fewer than the depth (the cell's deepest entry
    then a loser) it does not fire."""
    tm = 16
    levels = F.gstack_levels(k, tm)
    for hot, fires in ((levels + 3, True), (levels - 1, False)):
        q, c, rows = _planted(k, hot)
        qp = F.prepare_queries(torch.from_numpy(q), "dot", "highest")
        cp, cbp = F.prepare_corpus(torch.from_numpy(c), "dot",
                                   precision="highest")
        tps = 64   # one split holds every hot row
        splits = -(-c.shape[0] // (tps * 64))
        v, i, fired = F.gstack_partial_plain(qp, cp, cbp, None, k, "highest",
                                             splits, tps, tm)
        assert bool(fired[0, 0]) == fires
        assert F.gstack_fires(fired, tm) == ((1, 1) if fires else (0, 0))
        mv, mi, mf = gstack_partial(_raw_scores(qp, cp, cbp, None,
                                                "highest"),
                                    k, splits, tps, tm)
        np.testing.assert_array_equal(mf, fired.numpy())
        _same_bits(mv, mi, v, i)
        want_v, want_i = F.fused_topk_partial_plain(qp, cp, cbp, None, k,
                                                    "highest", splits, tps)
        got_v, got_i = F.fused_topk_partial(qp, cp, cbp, None, k, "highest",
                                            splits, tps, tm, gstack=True)
        _same_bits(got_v, got_i, want_v, want_i)
        top = min(k, hot)
        np.testing.assert_array_equal(got_i[0, 0, :top].numpy(),
                                      rows[::-1][:top])
        if fires and k > levels:
            # The cell dropped winners: its own list is not exact.
            assert not torch.equal(i[0, 0], want_i[0, 0])


def test_walk_with_no_query_rows():
    qp, cp, cbp, mask = _operands("random", 0, 300, 8, 1, "highest")
    v, i, fired = F.gstack_partial_plain(qp, cp, cbp, mask, 5, "highest",
                                         5, 1, 16)
    assert tuple(v.shape) == (0, 5, 5) and tuple(fired.shape) == (0, 5)
    assert F.gstack_fires(fired, 16) == (0, 0)


@pytest.mark.parametrize("k", (1, 10, 30))
def test_walk_on_tile_lists(k):
    """A list's rows in list order (its last id past the corpus), the
    splits cutting them, indices mapped back to the corpus."""
    n, tn = 1500, 128
    qp, cp, cbp, mask = _operands("ties", 4, n, 8, k, "bf16x3")
    tiles = torch.tensor([[0, 2, 3, 7, 11, 12]], dtype=torch.int32)
    want_v, want_i = F.fused_topk_partial_plain(qp, cp, cbp, mask, k,
                                                "bf16x3", 3, 4, tiles, tn, 4)
    gid, cp_b, cb_b, _ = F._listed(cp, cbp, None, tiles[0], tn, "bf16x3")
    v, i, fired = gstack_partial(_raw_scores(qp, cp_b, cb_b, None,
                                             "bf16x3"), k, 3, 4, 16)
    g = gid.numpy()
    i = np.where(i == INT32_MAX, i, g[np.minimum(i, g.size - 1)])
    _same_bits(v, i, want_v, want_i, ~fired)
    pv, pi, pf = F.gstack_partial_plain(qp, cp, cbp, mask, k, "bf16x3", 3,
                                        4, 16, tiles, tn, 4)
    _same_bits(pv, pi, v, i)
    np.testing.assert_array_equal(pf.numpy(), fired)


def test_fire_counts_by_block():
    fired = torch.zeros((37, 3), dtype=torch.bool)
    fired[0, 0] = fired[5, 0] = fired[36, 2] = fired[20, 1] = True
    assert F.gstack_fires(fired, 16) == (4, 3)
    assert F.gstack_fires(fired, 64) == (4, 3)
    fired[33, 1] = True
    assert F.gstack_fires(fired, 16) == (5, 4)


# ---------------------------------------------------------------------------
# The depth.
# ---------------------------------------------------------------------------


def _union_bound(k, tm, levels):
    return (F.GSTACK_BLOCKS * tm * math.comb(k, levels)
            / CELLS ** (levels - 1))


@pytest.mark.parametrize("tm", (16, 32, 64))
def test_levels_keep_the_launch_fire_bound(tm):
    """The least depth from one below the bound's level whose union bound
    on a launch's fire probability (264 blocks of tm rows) is at most
    GSTACK_FIRE."""
    for k in range(1, 129):
        levels = F.gstack_levels(k, tm)
        lo = (k - 1) // CELLS + 2
        assert lo <= levels <= F.GSTACK_MAX_LEVELS
        assert math.isclose(F.gstack_fire_bound(k, tm, levels),
                            _union_bound(k, tm, levels), rel_tol=1e-9)
        assert _union_bound(k, tm, levels) <= F.GSTACK_FIRE
        if levels > lo:
            assert _union_bound(k, tm, levels - 1) > F.GSTACK_FIRE
    assert [F.gstack_levels(k, 16) for k in (1, 2, 10, 16, 100)] == [
        2, 3, 6, 6, 13]
    assert F.gstack_levels(10, 64) == 6


def test_source_constants_are_the_hosts():
    want = {"kGstackCells": "kTN", "kGstackMaxLevels": str(
        F.GSTACK_MAX_LEVELS), "kGstackFire": str(F.GSTACK_FIRE),
        "kGstackBlocks": str(F.GSTACK_BLOCKS)}
    for name, value in want.items():
        m = re.search(rf"constexpr \w+ {name} = ([\w.]+);", SRC)
        assert m is not None and m.group(1) == value, name
    assert F.GSTACK_CELLS == F._TN == 64
    assert "levels = (k - 1) / kGstackCells + 2;" in SRC


# ---------------------------------------------------------------------------
# Routing.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("precision", F.CORES)
def test_gstack_built_where_its_stacks_fit(precision):
    """k <= 128 on the mma.sync ring and the f32 walk where the stacks
    fit beside a two-stage ring; never on the warpgroup consumer."""
    for tm in (16, 32, 64):
        for k in range(1, 140):
            levels = F.gstack_levels(k, tm)
            ring = 2 * (F.f32_stage_bytes(tm, False)
                        if precision == "highest"
                        else F.ring_staging(tm, precision, 256, False, 2)[0])
            fits = ring + F.gstack_tail_bytes(tm, levels) <= F.MAX_SMEM
            want = (k <= 128 and fits
                    and not F.wgmma_core(tm, precision))
            assert F.gstack_built(tm, precision, k) == want
            if want:
                plan = F.gstack_plan(tm, precision, 256, k)
                assert plan[0] >= 2 and plan[3] <= F.MAX_SMEM
    assert F.gstack_built(16, precision, 128)
    assert not F.gstack_built(16, precision, 129)
    assert F.gstack_built(64, precision, 5) == (precision in ("bf16x3",
                                                              "highest"))
    assert not F.gstack_built(64, precision, 10)


def test_gstack_route_takes_the_config():
    for sel in ("gstack", "gpop", "auto", "insert", "extract", "stack",
                "bucket"):
        for k, tm, listed in ((1, 16, False), (10, 32, True),
                              (16, 64, False), (100, 16, True)):
            for precision in F.CORES:
                assert F.gstack_route(sel, k, tm, listed, precision) == (
                    sel in ("gstack", "gpop"))


def test_check_selection_is_the_jax_envelope():
    """gpop: dense, at most 128 groups, k <= 16 and k < k_pad; gstack: k
    <= 1024 with a viable depth, a power-of-two tile past 128 groups; the
    port's messages are the JAX package's."""
    cases = [("gpop", 10, 100, False, 3, 128, 1),
             ("gpop", 17, 100, False, 3, 128, 1),
             ("gpop", 10, 200, False, 3, 128, 1),
             ("gpop", 10, 100, True, 3, 128, 1),
             ("gpop", 16, 100, False, 3, 16, 1),
             ("gstack", 100, 200, False, 9, 128, 16),
             ("gstack", 100, 200, False, 9, 128, 3),
             ("gstack", 1100, 200, False, 9, 2048, 16),
             ("gstack", 20, 300, True, 40, 128, 1)]
    for sel, k, groups, tiles, n_tiles, k_pad, gpt in cases:
        try:
            JF._resolve_selection(sel, k, groups, tiles, n_tiles, k_pad, gpt)
            want = None
        except ValueError as e:
            want = str(e)
        try:
            F.check_selection(sel, k, groups, tiles, n_tiles, k_pad, gpt)
            got = None
        except ValueError as e:
            got = str(e)
        assert got == want, (sel, k, groups, tiles)


def test_cpu_launch_is_the_plain_version():
    """On the CPU the gstack route is the plain version: the lists are the
    insertion's or the slack's, no gstack launch is counted, and a bad
    counter or a second selection raises."""
    qp, cp, cbp, mask = _operands("ties", 5, 700, 8, 3, "bf16x3")
    for k in (10, 60):
        before = dict(F.launches)
        got = F.fused_topk_partial(qp, cp, cbp, mask, k, "bf16x3", 3, 4, 16,
                                   gstack=True)
        want = F.fused_topk_partial(qp, cp, cbp, mask, k, "bf16x3", 3, 4, 16)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert F.launches["fused_topk_partial_gstack"] == before[
            "fused_topk_partial_gstack"]
    with pytest.raises(ValueError, match="gstack_count"):
        F.fused_topk_partial(qp, cp, cbp, mask, 10, "bf16x3", 3, 4, 16,
                             gstack=True,
                             gstack_count=torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="not both"):
        F.fused_topk_partial(qp, cp, cbp, mask, 10, "bf16x3", 3, 4, 16,
                             gstack=True, bucket=True)
    for sel in ("gstack", "gpop"):
        sv, si = F.fused_select(qp, cp, cbp, mask, 10, "bf16x3",
                                selection=sel)
        assert torch.equal(si, F.fused_select(qp, cp, cbp, mask, 10,
                                              "bf16x3")[1])


# ---------------------------------------------------------------------------
# The port against the JAX package's selection="gstack" / "gpop".
# ---------------------------------------------------------------------------


def _data(m, n, dim, seed):
    r = np.random.default_rng(seed)
    q = r.standard_normal((m, dim)).astype(np.float32)
    c = r.standard_normal((n, dim)).astype(np.float32)
    c[n // 2] = c[0]   # a duplicate across tiles (and segments)
    return q, c


def _same(pv, pi, jv, ji, **tol):
    assert_topk_equivalent(np.asarray(pi), np.asarray(pv), np.asarray(ji),
                           np.asarray(jv), **(tol or TOL))


@pytest.mark.parametrize("sel,metric,k,n,bn", [
    ("gstack", "cosine", 100, 3000, 1024),
    ("gstack", "dot", 7, 700, 128),
    ("gpop", "cosine", 16, 3000, 1024),
    ("gpop", "euclidean", 2, 90, 128),
])
def test_fused_topk_matches_jax(sel, metric, k, n, bn):
    q, c = _data(9, n, 24, seed=k + n)
    pv, pi = F.fused_topk(torch.from_numpy(q), torch.from_numpy(c), k,
                          metric, config=SearchConfig(
                              selection=sel, block_n=bn,
                              precision="highest"))
    jv, ji = JF.fused_topk(jnp.asarray(q), jnp.asarray(c), k, metric,
                           config=JConfig(block_q=16, block_n=bn,
                                          precision="highest",
                                          selection=sel),
                           interpret=True)
    _same(pv, pi, jv, ji)


def test_segmented_matches_jax():
    """More than 128 groups of 128 rows: the JAX package's segmented
    gstack (a panel a segment, one finish over them)."""
    q, c = _data(5, 20_000, 8, seed=34)
    k = 20
    pv, pi = F.fused_topk(torch.from_numpy(q), torch.from_numpy(c), k,
                          "cosine", config=SearchConfig(
                              selection="gstack", block_n=2048,
                              precision="highest"))
    jv, ji = JF.fused_topk(jnp.asarray(q), jnp.asarray(c), k, "cosine",
                           config=JConfig(block_q=8, block_n=2048,
                                          precision="highest",
                                          selection="gstack"),
                           interpret=True)
    _same(pv, pi, jv, ji)


def test_planted_collision_matches_jax():
    """The JAX package's own adversarial gstack input (its exact re-run
    fires) through both packages: the hot rows first, in order."""
    q, c, rows = _planted(16, 14, n=2048, spread=2)
    cfg = dict(block_n=1024, selection="gstack")
    pv, pi = F.fused_topk(torch.from_numpy(q), torch.from_numpy(c), 16,
                          "dot", config=SearchConfig(**cfg))
    jv, ji = JF.fused_topk(jnp.asarray(q), jnp.asarray(c), 16, "dot",
                           config=JConfig(block_q=8, **cfg), interpret=True)
    np.testing.assert_array_equal(pi.numpy()[0, :14], rows[::-1])
    _same(pv, pi, jv, ji, rtol=2e-5, atol=8e-6)


@pytest.mark.parametrize("sel", ["gstack", "gpop"])
def test_corpus_topk_matches_jax(sel):
    q, c = _data(12, 2500, 32, seed=5)
    jc = pmt.Corpus(c, config=JConfig(block_q=16, block_n=512,
                                      precision="highest", selection=sel))
    pc = pt.Corpus(c, config=SearchConfig(block_n=512, precision="highest",
                                          selection=sel), device="cpu")
    for k in (1, 10) if sel == "gpop" else (10, 64):
        ji, js = jc.topk(q, k)
        pi, ps = pc.topk(q, k)
        _same(ps, pi.astype(np.int64), js, ji.astype(np.int64))


def test_probed_matches_jax_gstack():
    """Tile lists under selection="gstack" (the JAX kernel's gstack over
    the visited tiles)."""
    q, c = _data(20, 1000, 32, seed=11)
    k = 10
    jcfg = JConfig(block_q=8, block_n=128, selection="gstack",
                   precision="highest")
    pcfg = SearchConfig(block_q=8, block_n=128, selection="gstack")
    tn = JF.corpus_tile_rows(q.shape[1], jcfg, k)
    tm = JF.query_tile_rows(q.shape[0], q.shape[1], jcfg, k)
    jcp, jcbp = JF.prepare_corpus(jnp.asarray(c), "cosine", tn=tn,
                                  precision="highest")
    cp, cbp = F.prepared_from_jax(np.asarray(jcp), np.asarray(jcbp),
                                  c.shape[0], c.shape[1])
    r = np.random.default_rng(k)
    tiles = np.stack([np.sort(r.choice(-(-1000 // tn), 4, replace=False))
                      for _ in range(-(-20 // tm))]).astype(np.int32)
    jv, ji = JF.fused_topk_prepared(jnp.asarray(q), jcp, jcbp, k, "cosine",
                                    tn=tn, config=jcfg, interpret=True,
                                    tiles=jnp.asarray(tiles))
    pv, pi = F.fused_topk_prepared(torch.from_numpy(q), cp, cbp, k,
                                   "cosine", config=pcfg,
                                   precision="highest", tiles=tiles, tn=tn)
    _same(pv, pi, jv, ji)


@pytest.fixture(scope="module")
def clustered(tmp_path_factory):
    r = np.random.default_rng(7)
    centers = r.standard_normal((20, 24)) * 4.0
    c = (centers[r.integers(0, 20, 3000)]
         + r.standard_normal((3000, 24))).astype(np.float32)
    q = (centers[r.integers(0, 20, 25)]
         + r.standard_normal((25, 24))).astype(np.float32)
    cfg = dict(block_q=8, block_n=128, selection="gstack")
    j = pmt.ClusteredCorpus(c, clusters=16, config=JConfig(**cfg))
    path = str(tmp_path_factory.mktemp("gstack") / "f32.npz")
    j.save(path)
    return q, j, pt.ClusteredCorpus.load(path, config=SearchConfig(**cfg),
                                         device="cpu")


@pytest.mark.parametrize("probe", [None, 0.25])
def test_clustered_topk_matches_jax(clustered, probe):
    q, j, h = clustered
    gi, gs = h.topk(q, 10, "cosine", probe=probe)
    wi, ws = j.topk(q, 10, "cosine", probe=probe)
    _same(gs, gi.astype(np.int64), ws, wi.astype(np.int64), rtol=1e-4,
          atol=5e-4)


def test_clustered_gpop_raises_as_jax(clustered):
    """gpop takes no probed scan: both packages raise the same error."""
    q, j, h = clustered
    errors = []
    for handle in (j, h):
        handle.config = handle.config.with_updates(selection="gpop")
        try:
            with pytest.raises(ValueError, match="gpop") as e:
                handle.topk(q, 10, "cosine", probe=0.25)
            errors.append(str(e.value))
        finally:
            handle.config = handle.config.with_updates(selection="gstack")
    assert errors[0] == errors[1]
