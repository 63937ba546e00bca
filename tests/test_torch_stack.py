"""Kernel A's stack selection (the port of the JAX kernel's ``_select_stack``,
k <= 128): a step model of its walk, where it is built, its routing
(``stack_route``), and the port against the JAX package's
``selection="stack"``.

Kernel A cannot run here.  The model below repeats the walk of
``csrc/fused_topk.cu``'s ``stack_tile`` / ``stack_window_end`` /
``stack_finish`` in NumPy, one query row and split at a time: windows of
STACK_WINDOW tiles; in each, the row's 64 cells (the columns of the
64-column tile) take the scores that beat the row's bound (the carry's
k-th value when the window began, strict >), a cell holding at most one
score a tile, so STACK_WINDOW of them; at the window's end the best cell
head is popped while it beats the carry entry it would displace, and the
popped entries and the carry are merged by rank.  It must give
``fused_topk_partial_plain``'s split lists bit for bit, and so must
``stack_partial_plain`` (the package's plain version of the walk, which
``chip_smoke.py`` and ``ab_kernel_a.py`` hold the card's lists to): on
seeded random scores, integer tie data, zero query rows, masked rows and
a wholly masked split, corpus rows and queries holding NaN and +-inf,
and data that puts a row's winners in one column.

``selection="stack"`` and "auto" take the stack in its class (dense,
17 <= k <= 32, query tiles 16 and 32, the bf16x3 and highest cores) and
kernel A's own selection elsewhere; the same seeded NumPy inputs go
through the JAX package with ``SearchConfig(selection="stack")`` (its
Pallas kernel in interpret mode, as its own tests run it) and through the
port's ``fused_topk`` and ``Corpus.topk`` on the CPU, and through the
stack's plain walk merged.  The
JAX stack truncates scores by up to 31 ulps (its group id in the low
mantissa bits), so they agree within its own tests' tolerance
(``assert_topk_equivalent``'s default), indices differing only on scores
tied within it.
"""

from __future__ import annotations

import bisect
import heapq
import importlib
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
from polars_matmul_tpu_torch.kernels import _build
from polars_matmul_tpu_torch.kernels import fused_topk as F

from conftest import assert_topk_equivalent

JF = importlib.import_module("polars_matmul_tpu.kernels.fused_topk")

CSRC = Path(F.__file__).parent / "csrc"
SRC = (CSRC / "fused_topk.cu").read_text()
INT32_MAX = 2 ** 31 - 1
NEG_INF = np.float32(-np.inf)
EMPTY = (NEG_INF, INT32_MAX)
CELLS = 64


# ---------------------------------------------------------------------------
# The step model.
# ---------------------------------------------------------------------------


def _key(e):
    """A (value desc, index asc) sort key of an entry, -0.0 as +0.0; the
    empty entry (-inf, INT32_MAX) sorts last."""
    v, i = e
    return (-float(v) if v != 0 else 0.0, int(i))


def stack_row(row, k):
    """One query row's split: ``row`` its scores (float32, a multiple of
    64 of them, NaN kept).  Returns the k (value, index) entries its
    carry writes."""
    window = F.STACK_WINDOW
    carry = [EMPTY] * k
    tiles = row.shape[0] // CELLS
    for w0 in range(0, tiles, window):
        bound = carry[k - 1][0]
        seg = row[w0 * CELLS:(w0 + window) * CELLS]
        with np.errstate(invalid="ignore"):
            cand = np.nonzero(seg > bound)[0]   # NaN and -inf never pass
        cells = [[] for _ in range(CELLS)]   # each best first
        for x in cand:   # in walk order
            cell = cells[int(x) % CELLS]
            assert len(cell) < window   # one score a tile: never full
            bisect.insort(cell, (seg[x], w0 * CELLS + int(x)), key=_key)
        heads = [0] * CELLS
        live = [(_key(cell[0]), c) for c, cell in enumerate(cells) if cell]
        heapq.heapify(live)
        popped = []
        while len(popped) < k and live:
            key, c = live[0]
            if key > _key(carry[k - 1 - len(popped)]):
                break   # it would not displace the carry's entry
            popped.append(cells[c][heads[c]])
            heads[c] += 1
            if heads[c] < len(cells[c]):
                heapq.heapreplace(live, (_key(cells[c][heads[c]]), c))
            else:
                heapq.heappop(live)
        # The merge by rank: a popped entry's place is its own plus the
        # carry entries above it, a kept carry entry's its own plus the
        # popped entries above it.
        carry_keys = [_key(e) for e in carry]
        popped_keys = [_key(e) for e in popped]
        out = [None] * k
        for i, e in enumerate(popped):
            out[i + bisect.bisect_left(carry_keys, popped_keys[i])] = e
        for j, e in enumerate(carry[:k - len(popped)]):
            out[j + bisect.bisect_left(popped_keys, carry_keys[j])] = e
        carry = out
    return carry


def stack_partial(scores, k, splits, tps):
    """The model over every row and split: (m, splits, k) values and
    global indices."""
    m = scores.shape[0]
    rows = tps * CELLS
    pad = np.full((m, splits * rows), NEG_INF, np.float32)
    pad[:, :scores.shape[1]] = scores
    v = np.empty((m, splits, k), np.float32)
    i = np.empty((m, splits, k), np.int32)
    for r in range(m):
        for s in range(splits):
            out = stack_row(pad[r, s * rows:(s + 1) * rows], k)
            v[r, s] = [e[0] for e in out]
            i[r, s] = [e[1] + s * rows if e[1] != INT32_MAX else INT32_MAX
                       for e in out]
    return v, i


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
    if kind == "masked":   # random rows, and the middle split wholly
        keep = r.random(n) < 0.6
        keep[n // 3: 2 * n // 3] = False
        mask = F.pad_mask_row(torch.from_numpy(keep), n)
    return qp, cp, cbp, mask


def _same_bits(v, i, want_v, want_i):
    np.testing.assert_array_equal(np.asarray(v).view(np.int32),
                                  np.asarray(want_v).view(np.int32))
    np.testing.assert_array_equal(np.asarray(i), np.asarray(want_i))


def _check(kind, k, splits, tps, n, precision="highest", m=3, dim=8,
           seed=None):
    """The model and the plain version of the walk against the exact
    split lists."""
    qp, cp, cbp, mask = _operands(kind, m, n, dim,
                                  seed=k + tps + n if seed is None else seed,
                                  precision=precision)
    want_v, want_i = F.fused_topk_partial_plain(qp, cp, cbp, mask, k,
                                                precision, splits, tps)
    v, i = stack_partial(_raw_scores(qp, cp, cbp, mask, precision), k,
                         splits, tps)
    _same_bits(v, i, want_v, want_i)
    pv, pi = F.stack_partial_plain(qp, cp, cbp, mask, k, precision, splits,
                                   tps)
    _same_bits(pv, pi, want_v, want_i)


@pytest.mark.parametrize("k", (1, 16, 17, 24, 32, 64, 100, 128))
def test_walk_equals_the_plain_version(k):
    """Seeded random scores and integer tie data: splits of one tile, of 3
    and of 21 (windows ending inside a split and at its end)."""
    for kind, precision in (("random", "highest"), ("ties", "bf16x3")):
        _check(kind, k, splits=20, tps=1, n=1200, precision=precision)
        _check(kind, k, splits=7, tps=3, n=1300, precision=precision)
        _check(kind, k, splits=2, tps=21, n=2600, precision=precision)


@pytest.mark.parametrize("k", (5, 40, 100))
@pytest.mark.parametrize("kind", ["zero", "masked", "nonfinite"])
def test_walk_on_zero_rows_masks_and_nonfinite_values(kind, k):
    """All-tied zero query rows, masked rows and a wholly masked split,
    corpus rows and queries holding NaN and +-inf (a NaN score never
    passes; a query's NaN row fills nothing)."""
    for precision in ("highest", "bf16x3", "int8c"):
        _check(kind, k, splits=3, tps=10, n=1900, precision=precision, m=5)


def _planted(hot, n=4096, d=16, spread=1):
    """The JAX package's planted collision: ``hot`` winners of one row,
    all in column 5 of their tiles (rows 5 + 64 spread j), above a
    corpus of small random rows; the other rows of column 5 score far
    below them all, so the column's cell holds the hot rows and then
    losers."""
    rng = np.random.default_rng(32 + hot)
    c = rng.standard_normal((n, d)).astype(np.float32) * 1e-3
    c[5::64] = -1.0
    q = np.ones((1, d), dtype=np.float32)
    rows = 5 + 64 * spread * np.arange(hot)
    c[rows] = (q[0] / np.linalg.norm(q[0])) * (2.0 + np.arange(hot))[:, None]
    return q, c, rows


@pytest.mark.parametrize("spread", (1, 2))
@pytest.mark.parametrize("k", (17, 64, 128))
def test_planted_collision_stays_exact(k, spread):
    """A row's winners all in one column, every tile of a window (spread
    1: the cell full at the window's end) or every other one: the cell
    holds them all, and the model and the plain version of the walk give
    the exact lists, the hot rows first."""
    hot = 48 // spread
    q, c, rows = _planted(hot, spread=spread)
    qp = F.prepare_queries(torch.from_numpy(q), "dot", "highest")
    cp, cbp = F.prepare_corpus(torch.from_numpy(c), "dot",
                               precision="highest")
    tps = 64   # one split holds every hot row
    splits = -(-c.shape[0] // (tps * 64))
    want_v, want_i = F.fused_topk_partial_plain(qp, cp, cbp, None, k,
                                                "highest", splits, tps)
    v, i = F.stack_partial_plain(qp, cp, cbp, None, k, "highest", splits,
                                 tps)
    _same_bits(v, i, want_v, want_i)
    mv, mi = stack_partial(_raw_scores(qp, cp, cbp, None, "highest"), k,
                           splits, tps)
    _same_bits(mv, mi, want_v, want_i)
    np.testing.assert_array_equal(want_i[0, 0, :min(k, hot)].numpy(),
                                  rows[::-1][:min(k, hot)])


def test_walk_with_no_query_rows():
    qp, cp, cbp, mask = _operands("random", 0, 300, 8, 1, "highest")
    v, i = F.stack_partial_plain(qp, cp, cbp, mask, 5, "highest", 5, 1)
    assert tuple(v.shape) == (0, 5, 5) and tuple(i.shape) == (0, 5, 5)


# ---------------------------------------------------------------------------
# The cells and where they are built.
# ---------------------------------------------------------------------------


def test_source_constants_are_the_hosts():
    """The window is the host's, its cells as deep (no depth of their own,
    no detector), and at most the JAX kernel's _STACK_DEPTH."""
    want = {"kStackWindow": str(F.STACK_WINDOW),
            "kStackStateWords": "1 + kGstackCells / 4"}
    for name, value in want.items():
        m = re.search(rf"constexpr \w+ {name} = ([^;]+);", SRC)
        assert m is not None and m.group(1) == value, name
    assert "static_assert(kStackWindow >= 1 && kStackWindow <= 8," in SRC
    assert F.STACK_WINDOW <= JF._STACK_DEPTH == 8
    body = SRC[SRC.index("struct StackState"):SRC.index("// The carry gate")]
    for word in ("flags", "sel_count", "atomicAdd", "fired"):
        assert word not in body, word


@pytest.mark.parametrize("precision", F.CORES)
def test_stack_built_where_its_tail_fits(precision):
    """k <= 128 at query tiles 16 and 32 on the bf16x3 ring and the
    highest core's f32 walk (its instantiations) where the tail (score
    tile, bounds, states, carries, cells, merge scratch) fits beside a
    two-stage ring; never on another core or at query tile 64."""
    for tm in (16, 32, 64):
        for k in range(1, 140, 3):
            tail = (tm * 65 * 4 + tm * 4 + tm * 17 * 4 + tm * k * 8
                    + tm * 64 * 4 * 8 + 8 * 2 * k * 8)
            assert F.stack_tail_bytes(tm, k) == tail
            ring = 2 * (F.f32_stage_bytes(tm, False)
                        if precision == "highest"
                        else F.ring_staging(tm, precision, 256, False,
                                            2)[0])
            want = (k <= 128 and ring + tail <= F.MAX_SMEM and tm <= 32
                    and precision in ("bf16x3", "highest"))
            assert F.stack_built(tm, precision, k) == want
    assert F.stack_built(16, precision, 128) == (precision in ("bf16x3",
                                                               "highest"))
    assert not F.stack_built(64, precision, 17)


# ---------------------------------------------------------------------------
# Routing.
# ---------------------------------------------------------------------------


def test_stack_route_takes_its_class():
    """"stack" and "auto" take the stack in its class (dense, 17 <= k <=
    32, query tiles 16 and 32, bf16x3 and highest, where its tail beside
    a two-stage ring leaves two blocks an SM) and nowhere else; every
    other value never; the source compiles it in a unit of its own."""
    assert (CSRC / "fused_topk_stack.cu").is_file()
    assert "fused_topk_stack.cu" in [p.name for p in _build._sources()]
    assert (F.STACK_MIN_K, F.STACK_MAX_K, F.STACK_MAX_TM) == (17, 32, 32)
    for sel in ("stack", "auto", "insert", "extract", "gstack", "gpop",
                "bucket"):
        for precision in F.CORES:
            for tm in (16, 32, 64):
                for k in range(1, 130):
                    for listed in (False, True):
                        least = 2 * (F.f32_stage_bytes(tm, False)
                                     if precision == "highest" else
                                     F.ring_staging(tm, precision, 256,
                                                    False, 2)[0])
                        two = (least + F.stack_tail_bytes(tm, k)
                               + 1024) * 2 <= 233472
                        want = (sel in ("stack", "auto") and not listed
                                and 17 <= k <= 32 and tm <= 32 and two
                                and precision in ("bf16x3", "highest"))
                        assert F.stack_route(sel, k, tm, listed,
                                             precision) == want
                        assert not want or F.stack_built(tm, precision, k)
    # bf16x3 at query tile 32 keeps two blocks up to k=24, highest to 32.
    assert F.stack_route("auto", 24, 32, False, "bf16x3")
    assert not F.stack_route("auto", 32, 32, False, "bf16x3")
    assert F.stack_route("auto", 32, 32, False, "highest")


def test_cpu_launch_is_the_plain_version():
    """On the CPU a launch that asks for the stack is the plain version:
    the slack's lists, no stack launch counted; a second selection
    raises."""
    qp, cp, cbp, mask = _operands("ties", 5, 900, 8, 3, "bf16x3")
    for k in (17, 32, 100):
        before = dict(F.launches)
        got = F.fused_topk_partial(qp, cp, cbp, mask, k, "bf16x3", 3, 5, 16,
                                   stack=True)
        want = F.fused_topk_partial(qp, cp, cbp, mask, k, "bf16x3", 3, 5, 16)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert F.launches["fused_topk_partial_stack"] == before[
            "fused_topk_partial_stack"]
    with pytest.raises(ValueError, match="not both"):
        F.fused_topk_partial(qp, cp, cbp, mask, 17, "bf16x3", 3, 5, 16,
                             stack=True, gstack=True)


@pytest.mark.parametrize("k", (17, 64, 128))
def test_selection_stack_keeps_the_lists(k):
    """selection="stack" gives the lists of selection="auto" (kernel A's
    own selection, or the stack in its class: the same bit for bit)."""
    qp, cp, cbp, mask = _operands("ties", 5, 900, 8, k, "bf16x3")
    got = F.fused_select(qp, cp, cbp, mask, k, "bf16x3", selection="stack")
    want = F.fused_select(qp, cp, cbp, mask, k, "bf16x3")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert F.selection(k) == "append"


@pytest.mark.parametrize("m, k, precision, want", [
    (8, 17, "bf16x3", ("fused", "stack", "bf16x3")),
    (32, 32, "highest", ("fused", "stack", "highest")),
    (32, 32, "bf16x3", ("fused", "bf16x3")),      # one block an SM
    (8, 33, "bf16x3", ("fused", "bf16x3")),       # above its class
    (8, 16, "bf16x3", ("fused", "bf16x3")),       # the insertion's k
    (100, 20, "bf16x3", ("fused", "bf16x3")),     # query tile 64
    (8, 20, "int8c", ("fused", "int8c")),         # a stored core
])
def test_launch_key_stack(m, k, precision, want):
    """Autotune keys a launch that takes the stack as its own: "auto" and
    "stack" in its class, the own selection's launch elsewhere."""
    from polars_matmul_tpu_torch.utils import autotune as A

    r = np.random.default_rng(3)
    q = torch.from_numpy(r.standard_normal((m, 32)).astype(np.float32))
    c = torch.from_numpy(r.standard_normal((300, 32)).astype(np.float32))
    for sel in ("auto", "stack"):
        cfg = SearchConfig(selection=sel, precision=precision)
        assert A._launch_key(cfg, q, c, k) == want
    assert A._launch_key(SearchConfig(selection="extract",
                                      precision=precision), q, c, k) == tuple(
        x for x in want if x != "stack")


def test_check_selection_is_the_jax_envelope():
    """stack: k <= 128 (the port's messages are the JAX package's)."""
    for k, groups, tiles, n_tiles in ((100, 20, False, 3), (129, 20, False, 3),
                                      (17, 300, True, 40), (128, 9, False, 9)):
        try:
            JF._resolve_selection("stack", k, groups, tiles, n_tiles, 128, 1)
            want = None
        except ValueError as e:
            want = str(e)
        try:
            F.check_selection("stack", k, groups, tiles, n_tiles, 128, 1)
            got = None
        except ValueError as e:
            got = str(e)
        assert got == want, (k, groups, tiles)


# ---------------------------------------------------------------------------
# The port against the JAX package's selection="stack".
# ---------------------------------------------------------------------------


def _jax(q, c, k, metric, bn):
    return JF.fused_topk(jnp.asarray(q), jnp.asarray(c), k, metric,
                         config=JConfig(block_q=8, block_n=bn,
                                        selection="stack"), interpret=True)


def _stack_merged(q, c, k, metric, tps=24):
    """The stack's plain walk, merged."""
    qp = F.prepare_queries(torch.from_numpy(q), metric, "bf16x3")
    cp, cbp = F.prepare_corpus(torch.from_numpy(c), metric,
                               precision="bf16x3")
    splits = -(-c.shape[0] // (tps * 64))
    v, i = F.stack_partial_plain(qp, cp, cbp, None, k, "bf16x3", splits, tps)
    return F.topk_merge(v, i, k)


@pytest.mark.parametrize("bn,k", [(1024, 17), (1024, 128), (2048, 64)])
def test_fused_topk_matches_jax(bn, k):
    """The shapes of the JAX package's multi-tile stack test."""
    r = np.random.default_rng(21 + k)
    q = r.standard_normal((9, 48)).astype(np.float32)
    c = r.standard_normal((3000, 48)).astype(np.float32)
    jv, ji = _jax(q, c, k, "cosine", bn)
    pv, pi = F.fused_topk(torch.from_numpy(q), torch.from_numpy(c), k,
                          "cosine", config=SearchConfig(selection="stack",
                                                        block_n=bn))
    assert_topk_equivalent(pi.numpy(), pv.numpy(), np.asarray(ji),
                           np.asarray(jv))
    sv, si = _stack_merged(q, c, k, "cosine")
    assert_topk_equivalent(si.numpy(), sv.numpy(), np.asarray(ji),
                           np.asarray(jv))


def test_planted_class_matches_jax():
    """The JAX package's adversarial stack input: 14 winners (more than
    _STACK_DEPTH) in one lane class of one 2048-row tile.  Both find them
    in order; the port's stack holds two a window in one cell and gives
    the same lists."""
    q, c, rows = _planted(14, n=2048, spread=2)
    k = 17
    jv, ji = _jax(q, c, k, "dot", 2048)
    pv, pi = F.fused_topk(torch.from_numpy(q), torch.from_numpy(c), k, "dot",
                          config=SearchConfig(selection="stack",
                                              block_n=2048))
    np.testing.assert_array_equal(np.asarray(ji)[0, :14], rows[::-1])
    np.testing.assert_array_equal(pi.numpy()[0, :14], rows[::-1])
    assert_topk_equivalent(pi.numpy(), pv.numpy(), np.asarray(ji),
                           np.asarray(jv))
    sv, si = _stack_merged(q, c, k, "dot", tps=32)
    np.testing.assert_array_equal(si.numpy(), pi.numpy())


def test_duplicate_rows_match_jax():
    """Duplicate corpus rows (the JAX stack's tie test, over tiles of 1024
    rows): the lowest index wins within a tile, across tiles and across
    the carry."""
    r = np.random.default_rng(23)
    base = r.standard_normal((4, 16)).astype(np.float32)
    c = np.concatenate([base] * 700)
    q = base[:1]
    k = 17
    _, ji = _jax(q, c, k, "dot", 1024)
    _, pi = F.fused_topk(torch.from_numpy(q), torch.from_numpy(c), k, "dot",
                         config=SearchConfig(selection="stack", block_n=1024))
    _, si = _stack_merged(q, c, k, "dot")
    ji = np.asarray(ji)[0]
    assert ji[0] < 4
    np.testing.assert_array_equal(ji, ji[0] + 4 * np.arange(k))
    np.testing.assert_array_equal(pi.numpy()[0], ji)
    np.testing.assert_array_equal(si.numpy()[0], ji)


def test_corpus_topk_matches_jax():
    r = np.random.default_rng(5)
    q = r.standard_normal((12, 32)).astype(np.float32)
    c = r.standard_normal((2500, 32)).astype(np.float32)
    c[1250] = c[0]
    jc = pmt.Corpus(c, config=JConfig(block_q=8, block_n=1024,
                                      selection="stack"))
    pc = pt.Corpus(c, config=SearchConfig(block_n=1024, selection="stack"),
                   device="cpu")
    ji, js = jc.topk(q, 64)
    pi, ps = pc.topk(q, 64)
    assert_topk_equivalent(pi.astype(np.int64), ps, ji.astype(np.int64), js)
