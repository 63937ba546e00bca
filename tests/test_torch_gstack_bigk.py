"""Kernel A's gstack selection above k = 128 (``selection="gstack"``, 128 <
k <= 1024): a step model of its walk, its plan and geometry, its routing,
and the port against the JAX package's big-k gstack.

Kernel A cannot run here.  The model below repeats the walk of
``csrc/fused_topk.cu``'s ``gstack_big_tile`` / ``gstack_big_finish`` in
NumPy, one query row and split at a time: the row's 64 cells (the columns
of the 64-column tile), each the best ``levels`` entries of its column
across the split, sorted; the row's bound, the weakest entry of level
(k - 1) // 64 over the 64 cells (-inf while a cell holds fewer), raised
after a tile in which the row put any, which a score must beat (strict >)
before its cell's deepest entry; a cell lost once a score beating the bound
meets it full; then k pops of the best cell head, the row firing only when
a pop takes the deepest entry of a lost cell.  Every score the bound
refuses is checked to lie outside the split's top k.  The model must give
``fused_topk_partial_plain``'s split lists bit for bit wherever the row
does not fire, and ``gstack_partial_plain`` (the package's plain version of
the walk, which ``chip_smoke.py`` holds the card's fire counter to)
everywhere: seeded random scores, integer tie data, zero query rows, masked
rows and wholly masked splits, rows and queries holding NaN and +-inf, and
tile lists.  Where the stacks are as deep as the split is long (lossless)
nothing fires, planted collisions included; where they are not (lossy),
planted collisions fire and the launch stays exact.

Then the plan and the geometry (``gstack_big_plan``, ``gstack_geometry``
against the source's constants and the rules written out), the CPU launch
(the plain version), ``check_selection`` (the JAX package's envelope above
k = 128), and the same seeded NumPy inputs through the JAX package's
``fused_topk`` with ``SearchConfig(selection="gstack")`` (its Pallas kernel
in interpret mode, as its own tests run it) and the port's public ``topk``
and ``Corpus.topk`` at the size of the JAX package's
``test_gstack_bigk_single_segment`` (4 x 3000 x 16): within
``assert_topk_equivalent``, and with the JAX package's index sets exactly.
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
TM = F.GSTACK_BIG_TM


# ---------------------------------------------------------------------------
# The step model.
# ---------------------------------------------------------------------------


def _key(v, i):
    """A (value desc, index asc) sort key, -0.0 as +0.0."""
    return (-float(v) if v != 0 else 0.0, int(i))


def big_row(row, k, levels):
    """One query row's split: ``row`` its scores (float32, a multiple of
    64 of them, NaN kept).  Returns (the k (value, index) pairs the pop
    finish writes, fired)."""
    exact = sorted(((s, j) for j, s in enumerate(row) if s > NEG_INF),
                   key=lambda e: _key(*e))[:k]
    top = {j for _, j in exact}
    cells = [[] for _ in range(CELLS)]   # each best first, at most levels
    lost = [False] * CELLS
    lvl = (k - 1) // CELLS
    bound = NEG_INF
    for n0 in range(0, row.shape[0], CELLS):
        put = False
        for col in range(CELLS):
            s = row[n0 + col]
            with np.errstate(invalid="ignore"):
                beats = s > bound
            if not beats:   # NaN and -inf never pass
                assert n0 + col not in top, "the bound refused a top-k score"
                continue
            cell = cells[col]
            if len(cell) == levels:
                lost[col] = True
                if _key(s, n0 + col) > _key(*cell[-1]):
                    continue   # does not beat the deepest entry
            cell.append((s, n0 + col))
            cell.sort(key=lambda e: _key(*e))
            del cell[levels:]
            put = True
        if put:
            weakest = [cell[lvl] if len(cell) > lvl else None
                       for cell in cells]
            bound = (NEG_INF if None in weakest else
                     max(weakest, key=lambda e: _key(*e))[0])
    heads = [0] * CELLS
    out, fired = [], False
    for _ in range(k):
        live = [c for c in range(CELLS) if heads[c] < len(cells[c])]
        if not live:
            break
        c = min(live, key=lambda c: _key(*cells[c][heads[c]]))
        out.append(cells[c][heads[c]])
        fired |= heads[c] == levels - 1 and lost[c]
        heads[c] += 1
    return out + [(NEG_INF, INT32_MAX)] * (k - len(out)), fired


def big_partial(scores, k, splits, tps, levels):
    """The model over every row and split: (m, splits, k) values and
    global indices, (m, splits) fired."""
    m = scores.shape[0]
    rows = tps * 64
    pad = np.full((m, splits * rows), NEG_INF, np.float32)
    pad[:, :scores.shape[1]] = scores
    v = np.empty((m, splits, k), np.float32)
    i = np.empty((m, splits, k), np.int32)
    fired = np.zeros((m, splits), bool)
    for r in range(m):
        for s in range(splits):
            out, fired[r, s] = big_row(pad[r, s * rows:(s + 1) * rows], k,
                                       levels)
            v[r, s] = [e[0] for e in out]
            i[r, s] = [e[1] + s * rows if e[1] != INT32_MAX else INT32_MAX
                       for e in out]
    return v, i, fired


# ---------------------------------------------------------------------------
# Operands and the model against the plain versions.
# ---------------------------------------------------------------------------


def _raw_scores(qp, cp, cbp, mask, precision):
    """The epilogue's scores as kernel A holds them: NaN kept (its strict
    > drops it), masked rows -inf."""
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
        q[1, 0] = np.nan
    if kind == "planted":   # column 5 of every tile beats every other row
        q = np.abs(q)
        c[5::64] += 3.0
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


def _check(kind, k, splits, tps, n, precision="highest", m=3, dim=8,
           seed=None):
    """The model against the plain versions; returns (m, splits) fired
    and whether the plan is lossless."""
    levels, built = F.gstack_big_plan(TM, precision, k, tps)
    assert built
    qp, cp, cbp, mask = _operands(kind, m, n, dim,
                                  seed=k + tps + n if seed is None else seed,
                                  precision=precision)
    want_v, want_i = F.fused_topk_partial_plain(qp, cp, cbp, mask, k,
                                                precision, splits, tps)
    v, i, fired = big_partial(_raw_scores(qp, cp, cbp, mask, precision),
                              k, splits, tps, levels)
    _same_bits(v, i, want_v, want_i, ~fired)
    pv, pi, pf = F.gstack_partial_plain(qp, cp, cbp, mask, k, precision,
                                        splits, tps, TM)
    _same_bits(pv, pi, v, i)
    np.testing.assert_array_equal(pf.numpy(), fired)
    # The launch (its re-walk included) is the plain version everywhere.
    got_v, got_i = F.fused_topk_partial(qp, cp, cbp, mask, k, precision,
                                        splits, tps, TM, gstack=True)
    _same_bits(got_v, got_i, want_v, want_i)
    return fired, levels >= tps


# Splits of a few tiles (lossless), of 24 (the deepest lossless stacks of
# one block) and of 40 (lossy: past the 32 levels).
@pytest.mark.parametrize("k,tps", [(129, 3), (129, 40), (200, 12),
                                   (256, 40), (300, 24), (512, 9),
                                   (512, 24), (1024, 17)])
def test_walk_equals_the_plain_version(k, tps):
    fired, lossless = _check("random", k, 2, tps, n=2 * tps * 64 - 37)
    assert lossless == (tps <= F.GSTACK_BIG_MAX_LEVELS)
    assert not fired.any()


@pytest.mark.parametrize("kind", ["ties", "zero", "masked", "nonfinite"])
@pytest.mark.parametrize("tps", [7, 36])
def test_walk_on_zero_rows_masks_and_nonfinite_values(kind, tps):
    fired, lossless = _check(kind, 200, 3, tps, n=3 * tps * 64 - 100, m=4)
    assert not (lossless and fired.any())


@pytest.mark.parametrize("precision", ["bf16x3", "int8c"])
def test_walk_in_other_cores(precision):
    _check("ties", 160, 2, 10, n=1200, precision=precision, m=2, dim=16)


@pytest.mark.parametrize("tps", [20, 34, 60])
def test_planted_collision_fires_only_where_lossy(tps):
    """Column 5 of every tile holds every row's best scores: a cell that
    keeps them all never fires (lossless); one of fewer levels than the
    split has tiles overflows, and its row fires."""
    fired, lossless = _check("planted", 140, 2, tps, n=2 * tps * 64, m=3,
                             dim=8, seed=5)
    assert fired.all() != lossless


def test_walk_on_tile_lists():
    """A listed walk: the splits cut each list's rows, the indices are
    global, and the lossless plan takes the positions' count."""
    qp, cp, cbp, mask = _operands("ties", 16, 5000, 8, 11, "highest")
    tiles = torch.tensor([[0, 2, 3, 7], [1, 4, 5, 6]], dtype=torch.int32)
    tn = 640   # 10 kernel tiles a layout tile, 40 positions a list
    for splits, tps in ((2, 20), (1, 40)):
        want = F.fused_topk_partial_plain(qp, cp, cbp, mask, 300, "highest",
                                          splits, tps, tiles, tn, 8)
        pv, pi, pf = F.gstack_partial_plain(qp, cp, cbp, mask, 300,
                                            "highest", splits, tps, TM,
                                            tiles, tn, 8)
        _same_bits(pv, pi, *want, ~pf.numpy())
        assert not pf.any()


# ---------------------------------------------------------------------------
# The plan, the geometry and the source.
# ---------------------------------------------------------------------------


def _src_int(name):
    return int(re.search(rf"constexpr \w+ {name} = (\w+);", SRC).group(1), 0)


def test_source_constants_are_the_hosts():
    assert _src_int("kGstackBigTM") == F.GSTACK_BIG_TM
    assert _src_int("kGstackBigMaxLevels") == F.GSTACK_BIG_MAX_LEVELS
    assert _src_int("kGstackBigMaxK") == F._MAX_FUSED_K
    assert ("levels * sizeof(uint64_t)\n       + (size_t)tm * kGstackCells;"
            in SRC)
    for tm, levels in ((16, 27), (16, 24), (32, 9)):
        assert F.gstack_big_tail_bytes(tm, levels) == (
            tm * 65 * 4 + tm * 4 + tm * 64 * levels * 8 + tm * 64)


@pytest.mark.parametrize("precision", F.CORES)
def test_plan_rules(precision):
    """Lossless (levels = max(tps, ceil(k/64))) wherever that fits within
    the cap; else the least depth whose fire bound is at most 5 %; built
    only at query tile 16, 128 < k <= 1024, where its 8-byte keys fit
    beside the ring's least plan."""
    ring = F._least_ring(TM, precision)
    for k in (129, 192, 256, 300, 512, 777, 1024):
        least = -(-k // 64)
        for tps in (1, 5, 20, 25, 27, 32, 33, 79, 237, 32768, 40000):
            levels, built = F.gstack_big_plan(TM, precision, k, tps)
            assert F.gstack_built(TM, precision, k, tps) == built
            if max(tps, least) <= F.GSTACK_BIG_MAX_LEVELS:
                assert levels == max(tps, least)
            else:
                assert levels >= least and (
                    F.gstack_fire_bound(k, TM, levels) <= F.GSTACK_FIRE
                    or levels == 2 * F.GSTACK_BIG_MAX_LEVELS)
                assert levels == least or F.gstack_fire_bound(
                    k, TM, levels - 1) > F.GSTACK_FIRE
            nbytes = ring + F.gstack_big_tail_bytes(TM, levels)
            assert built == (levels <= F.GSTACK_BIG_MAX_LEVELS
                             and nbytes <= F.MAX_SMEM)
            assert F.gstack_big_bytes(TM, precision, levels) == nbytes
            if built:
                stages, _, _, nbytes = F.gstack_big_ring(
                    TM, precision, F._corpus_width(precision, 256), k, tps)
                assert stages >= 2 and nbytes <= F.MAX_SMEM
        for tm in (32, 64):
            assert not F.gstack_big_plan(tm, precision, k, 3)[1]
    assert not F.gstack_big_plan(TM, precision, 1025, 3)[1]
    assert not F.gstack_big_plan(TM, precision, 128, 3)[1]


def test_not_built_cases_and_their_bytes():
    """Over 237-tile splits (2M rows at batch 8) k=1024 wants 54 levels
    (471,168 B beside the bf16x3 ring's least plan) and k=512 32 (290,944
    B): not built; k=256 takes 21 (200,832 B), lossy.  One block's 8-byte
    keys reach 24 levels in bf16x3 (225,408 B), not 25 (233,600 B)."""
    assert F.gstack_big_plan(TM, "bf16x3", 1024, 237) == (54, False)
    assert F.gstack_big_bytes(TM, "bf16x3", 54) == 471168
    assert F.gstack_big_plan(TM, "bf16x3", 512, 237) == (32, False)
    assert F.gstack_big_bytes(TM, "bf16x3", 32) == 290944
    assert F.gstack_big_plan(TM, "bf16x3", 256, 237) == (21, True)
    assert F.gstack_big_bytes(TM, "bf16x3", 21) == 200832
    assert F.gstack_big_plan(TM, "bf16x3", 300, 24) == (24, True)
    assert F.gstack_big_plan(TM, "bf16x3", 512, 25) == (25, False)
    assert F.gstack_big_bytes(TM, "bf16x3", 25) > F.MAX_SMEM


def test_geometry():
    """Canonical (1000 x 10,000): bf16x3 and highest up to k = 640 take
    two blocks an SM on 16 splits of 10 tiles (110,720 B in bf16x3),
    lossless within GSTACK_WAVES waves, filling the last; above it, and in
    the stored cores past k = 129 (int4c k = 256 aside), no lossless plan
    leaves two blocks and the lossy one at launch_geometry's 3 splits does
    not fit: not built (None).  2M rows at batch 8 keep launch_geometry's
    132 splits at one block an SM (lossless would take 977: 7.4 waves),
    lossy, built to k = 256; a tile list of 1632 positions for 32 queries
    lossless; the splits cover the rows and stay within _MAX_SPLITS."""
    sms = 132
    for core in ("bf16x3", "highest"):
        for k in (129, 512, 640):
            assert F.gstack_geometry(1000, 10_000, k, core, sms) == (
                16, 16, 10)
            assert F.gstack_big_plan(16, core, k, 10) == (10, True)
        assert F.gstack_geometry(1000, 10_000, 1024, core, sms) is None
    assert F.gstack_deepest("bf16x3", 512) == 10
    assert F.gstack_deepest("bf16x3", 1024) == 0
    assert F._SMEM_PER_SM // (F.gstack_big_bytes(16, "bf16x3", 10)
                              + F._SMEM_PER_BLOCK) == 2
    assert F.gstack_geometry(1000, 10_000, 129, "int8c", sms) == (16, 3, 53)
    assert F.gstack_geometry(1000, 10_000, 256, "int4c", sms) == (16, 3, 53)
    for core in ("bf16c", "int8c", "int4c"):
        assert F.gstack_geometry(1000, 10_000, 512, core, sms) is None
    assert F.gstack_geometry(8, 2_000_000, 256, "bf16x3", sms) == (
        16, 132, 237)
    assert F.gstack_big_plan(16, "bf16x3", 256, 237) == (21, True)
    assert F.gstack_geometry(8, 2_000_000, 512, "bf16x3", sms) is None
    tm, splits, tps = F.gstack_geometry(32, 1632 * 64, 256, "bf16x3", sms)
    assert F.gstack_big_plan(tm, "bf16x3", 256, tps)[0] >= tps
    for m in (1, 8, 100, 1000, 5000):
        for n in (64, 3000, 10_000, 300_000, 2_000_000, 10_000_000):
            for k in (129, 512, 1024):
                geo = F.gstack_geometry(m, n, k, "bf16x3", sms)
                one = F.launch_geometry(m, n, k, sms, 1, 16)
                if geo is None:   # nor is the lossy plan at one block
                    assert not F.gstack_big_plan(16, "bf16x3", k, one[2])[1]
                    continue
                tm, splits, tps = geo
                n_tiles = -(-n // 64)
                assert splits * tps >= n_tiles > (splits - 1) * tps
                assert 1 <= splits <= F._MAX_SPLITS
                if tps <= F.gstack_deepest("bf16x3", k):   # lossless
                    assert F.gstack_big_plan(tm, "bf16x3", k, tps)[0] >= tps
                    assert -(-m // 16) * splits <= F.GSTACK_WAVES * 2 * sms
                else:   # lossy: launch_geometry's at one block an SM
                    assert (splits, tps) == one[1:]
                    assert F.gstack_big_plan(tm, "bf16x3", k, tps)[1]


# ---------------------------------------------------------------------------
# Routing, the CPU launch and the JAX envelope.
# ---------------------------------------------------------------------------


def test_cpu_launch_is_the_plain_version():
    """On the CPU the gstack route above k = 128 is the plain version: the
    radix selection's lists, no gstack launch counted; gstack_built needs
    the split's length there (without it: the form of k <= 128, not
    built)."""
    qp, cp, cbp, mask = _operands("ties", 5, 900, 8, 3, "bf16x3")
    before = dict(F.launches)
    got = F.fused_topk_partial(qp, cp, cbp, mask, 300, "bf16x3", 2, 8, 16,
                               gstack=True)
    want = F.fused_topk_partial(qp, cp, cbp, mask, 300, "bf16x3", 2, 8, 16)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert F.launches["fused_topk_partial_gstack_bigk"] == before[
        "fused_topk_partial_gstack_bigk"]
    assert not F.gstack_built(16, "bf16x3", 300)
    assert F.gstack_built(16, "bf16x3", 300, 8)
    sv, si = F.fused_select(qp, cp, cbp, mask, 300, "bf16x3",
                            selection="gstack")
    assert torch.equal(si, F.fused_select(qp, cp, cbp, mask, 300,
                                          "bf16x3")[1])


def test_check_selection_raises_as_jax_above_128():
    """Above k = 128: bucket, stack and insert raise; gstack raises past
    k = 1024, where no depth keeps its overflow bound, and on tiles that
    cannot be segmented; the port's messages are the JAX package's."""
    cases = [(sel, k, groups, tiles, n_tiles, 2048, gpt)
             for sel in ("gstack", "bucket", "stack", "insert", "auto",
                         "extract")
             for k in (129, 300, 1024, 1025)
             for groups, tiles, n_tiles, gpt in (
                 (24, False, 3, 8), (15_625, False, 1954, 8),
                 (200, False, 9, 3), (300, True, 40, 1),
                 (100_000, False, 12_500, 8))]
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


# ---------------------------------------------------------------------------
# The port against the JAX package's selection="gstack" above k = 128.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_bigk():
    """The JAX package's gstack at the size of its own big-k test (4 x
    3000 x 16, dot), k = 129, 200 and 300, in interpret mode."""
    rng = np.random.default_rng(201)
    q = rng.standard_normal((4, 16)).astype(np.float32)
    c = rng.standard_normal((3000, 16)).astype(np.float32)
    out = {}
    for k in (129, 200, 300):
        jv, ji = JF.fused_topk(jnp.asarray(q), jnp.asarray(c), k, "dot",
                               config=JConfig(selection="gstack"),
                               interpret=True)
        out[k] = (np.asarray(jv), np.asarray(ji))
    return q, c, out


@pytest.mark.parametrize("k", [129, 200, 300])
@pytest.mark.parametrize("surface", ["topk", "corpus"])
def test_public_matches_jax(jax_bigk, k, surface):
    q, c, out = jax_bigk
    jv, ji = out[k]
    cfg = SearchConfig(selection="gstack")
    if surface == "topk":
        pi, ps = pt.topk(q, c, k, "dot", config=cfg, device="cpu")
    else:
        pi, ps = pt.Corpus(c, config=cfg, device="cpu").topk(q, k, "dot")
    pi, ps = np.asarray(pi).astype(np.int64), np.asarray(ps)
    assert_topk_equivalent(pi, ps, ji.astype(np.int64), jv)
    # Random f32 scores do not tie: the same rows, in the same order.
    for r in range(q.shape[0]):
        assert set(pi[r]) == set(ji[r].astype(np.int64))
    np.testing.assert_array_equal(pi, ji.astype(np.int64))


def test_depth_cap_is_the_jax_packages():
    """The lossy search stops at the JAX kernel's cap of stack levels, and
    the fire bound is the k <= 128 gstack's union bound written out."""
    assert F.GSTACK_BIG_MAX_LEVELS == JF._BIGK_MAX_LEVELS
    for k, levels in ((129, 14), (256, 21), (512, 32)):
        b = F.GSTACK_BLOCKS * TM * math.comb(k, levels) / CELLS ** (
            levels - 1)
        assert F.gstack_fire_bound(k, TM, levels) == pytest.approx(b)
