"""Kernel A's radix selection (k above ``APPEND_MAX_K``): a step-by-step
model of the walk, the plans beside it, and the port against the JAX
package at such k.

Kernel A cannot run here.  Above the crossover its selection
(``csrc/fused_topk.cu``: ``radix_tile``, ``radix_select``,
``radix_finish``) keeps an unsorted buffer of ``radix_buffer(k)`` 64-bit
keys a row (``sel_key``, mirrored by ``fused_topk.select_keys``) and one
threshold word.  The model below repeats it in NumPy: the strict filter
against the threshold, the ballot's append order, the buffer's fill rule
(a select when a tile's candidates do not fit, then the tile filtered
again), the radix passes (RADIX_BITS-bit digits from the top, the counts
of the entries that match the digits found, the scan from the top digit
down, the stop when the bucket holds exactly the entries still wanted),
the compaction in buffer order, and the final sort (the bitonic network in
its flip form, the places past the keys empty).  It must give
``fused_topk_partial_plain``'s split lists bit for bit at every k from the
crossover to 1024: seeded random scores, integer tie data, a buffer filled
exactly and one entry past, short and one-tile splits, zero query rows,
masked rows and wholly masked splits, NaN and +-inf corpus rows and
queries (the non-finite rule: such scores never enter), and 4-tile steps.
Then the plans: the radix selection keeps the carry's shared memory, so
each (core, query tile, k) keeps its blocks an SM (the literals below).
Last, the same seeded NumPy inputs through the JAX package and through the
port on the CPU, held to ``assert_topk_equivalent``'s tolerance.
"""

import numpy as np
import pytest
import torch

from polars_matmul_tpu.config import SearchConfig as JConfig
import polars_matmul_tpu.api.search as JAPI
from polars_matmul_tpu_torch import topk
from polars_matmul_tpu_torch.kernels import fused_topk as F

from conftest import assert_topk_equivalent

torch.set_num_threads(2)

U = np.uint64
SIGN = U(1 << 63)
EMPTY = np.array([F.EMPTY_KEY], np.int64).view(U)[0] ^ SIGN
CROSS = F.APPEND_MAX_K + 1   # the first k of the radix selection
KS = (CROSS, 200, 256, 512, 1024)


def _keys(v, i):
    """The source's unsigned sel_keys of values v and indices i."""
    k = F.select_keys(torch.as_tensor(np.asarray(v, np.float32)),
                      torch.as_tensor(np.asarray(i, np.int32))).numpy()
    return k.view(U) ^ SIGN


def _values(keys):
    return F.key_values(torch.from_numpy(
        (np.asarray(keys, U) ^ SIGN).view(np.int64))).numpy()


def _indices(keys):
    return F.key_indices(torch.from_numpy(
        (np.asarray(keys, U) ^ SIGN).view(np.int64))).numpy()


# ---------------------------------------------------------------------------
# The model (csrc/fused_topk.cu: radix_select, radix_tile, radix_refill,
# sort_block, sort_keys, radix_finish).
# ---------------------------------------------------------------------------


def radix_select(buf, k):
    """radix_select: the k-th best of the buffered keys ``buf`` (at least
    k, distinct) and the k entries at or above it, in buffer order; and the
    passes it took."""
    bins = 1 << F.RADIX_BITS
    prefix, top, want, passes = 0, 64, k, 0
    while True:
        width = min(top, F.RADIX_BITS)
        shift = top - width
        match = buf if top == 64 else buf[(buf >> U(top)) == U(prefix >> top)]
        digit = ((match >> U(shift)) & U((1 << width) - 1)).astype(np.int64)
        count = np.bincount(digit, minlength=bins)
        assert count.max() < 1 << 16   # two 16-bit counts a word
        # The scan from the top digit down.
        upto = np.cumsum(count[::-1])[::-1]   # digits >= d
        here = np.flatnonzero((upto - count < want) & (want <= upto))
        assert len(here) == 1
        d = int(here[0])
        want -= int(upto[d] - count[d])
        prefix |= d << shift
        top = shift
        passes += 1
        if count[d] == want:
            break
    keep = (buf >> U(top)) >= U(prefix >> top)
    kept = buf[keep]
    assert len(kept) == k
    return kept.min(), kept, passes


def _flip(a, m):
    """sort_stage / sort_stage_shared: place x meets x ^ m, the lower keeps
    the better key."""
    x = np.arange(len(a))
    lo = x[x < (x ^ m)]
    hi = lo ^ m
    best, worst = np.maximum(a[lo], a[hi]), np.minimum(a[lo], a[hi])
    a[lo], a[hi] = best, worst


def flip_sort(keys):
    """sort_keys: the flip form of the bitonic network over the keys
    padded with empty keys to a power of two of at least the register
    block (128, 256 or 512 keys: the least that holds them, 512 above);
    the blocks and the stages in shared memory run the same stages in the
    same order."""
    n = len(keys)
    pad = 128 if n <= 128 else 256 if n <= 256 else 512
    while pad < n:
        pad *= 2
    a = np.concatenate([keys, np.full(pad - n, EMPTY, U)])
    size = 2
    while size <= pad:
        _flip(a, size - 1)
        s = size // 4
        while s >= 1:
            _flip(a, s)
            s //= 2
        size *= 2
    assert (a[n:] == EMPTY).all()   # no empty place moved below a key
    return a[:n]


def model_partial(scores, k, splits, tps, step=1, cap=None, stats=None):
    """The radix selection's split lists of (m, n) raw f32 scores (NaN
    where the epilogue gives NaN): each split's tiles in walk order (``step``
    tiles a step, as the highest core's walk takes them), a buffer of
    ``cap`` entries a row (the kernel's radix_buffer(k))."""
    cap = cap or F.radix_buffer(k)
    m, n = scores.shape
    n_tiles = -(-n // F._TN)
    pad = np.full((m, splits * tps * F._TN), -np.inf, np.float32)
    pad[:, :n] = scores
    out_v = np.empty((m, splits, k), np.float32)
    out_i = np.empty((m, splits, k), np.int32)
    for row in range(m):
        for sp in range(splits):
            buf = np.empty(0, U)
            thr = np.float32(-np.inf)
            t_begin, t_end = sp * tps, min(n_tiles, (sp + 1) * tps)
            for t0 in range(t_begin, t_end, step):
                for t in range(t0, min(t0 + step, t_end)):
                    n0 = t * F._TN
                    s = pad[row, n0:n0 + F._TN]
                    c = s > thr
                    if not c.any():
                        continue
                    if len(buf) + int(c.sum()) > cap:
                        kth, buf, passes = radix_select(buf, k)
                        thr = _values([kth])[0]
                        c = s > thr
                        if stats is not None:
                            stats.append(passes)
                    # The ballot's order: lanes 0-31, then 32-63.
                    buf = np.concatenate(
                        [buf, _keys(s[c], n0 + np.flatnonzero(c))])
                    assert len(buf) <= cap
            if len(buf) > k:
                buf = radix_select(buf, k)[1]
            srt = flip_sort(buf)
            np.testing.assert_array_equal(srt, np.sort(buf)[::-1])
            out_v[row, sp] = -np.inf
            out_i[row, sp] = F.INT32_MAX
            out_v[row, sp, :len(srt)] = _values(srt)
            out_i[row, sp, :len(srt)] = _indices(srt)
    return out_v, out_i


def _operands(kind, m, n, dim, seed, precision):
    r = np.random.default_rng(seed)
    if kind == "ties":   # integer entries, every corpus row twinned
        q = r.integers(-2, 3, (m, dim)).astype(np.float32)
        c = r.integers(-2, 3, (n, dim)).astype(np.float32)
        c[n // 2:] = c[: n - n // 2]
        metric = "dot"
    else:
        q = r.standard_normal((m, dim)).astype(np.float32)
        c = r.standard_normal((n, dim)).astype(np.float32)
        metric = "cosine"
    if kind == "zero":
        q[::2] = 0.0
    if kind == "nonfinite":   # bad corpus rows and a NaN / +inf query
        c[3::41, 0] = np.nan
        c[5::41, 1] = np.inf
        c[7::41, 2] = -np.inf
        q[1, 0] = np.nan
        if m > 2:
            q[2, 3] = np.inf
        metric = "dot"
    qt, ct = torch.from_numpy(q), torch.from_numpy(c)
    qp = F.prepare_queries(qt, metric, precision)
    cp, cbp = F.prepare_corpus(ct, metric, precision=precision)
    mask = None
    if kind == "masked":   # random rows, and the second split wholly
        keep = r.random(n) < 0.6
        keep[n // 3: 2 * n // 3] = False
        mask = F.pad_mask_row(torch.from_numpy(keep), n)
    return qp, cp, cbp, mask


def _raw_scores(qp, cp, cbp, mask, precision):
    """The scores kernel A's selection sees: the product through the
    epilogue, NaN kept, masked rows -inf."""
    s = F._plain_scores(qp, cp, precision)
    s = s * cbp[0] + cbp[1] if precision in F._QUANT else s + cbp
    if mask is not None:
        s = torch.where(mask.to(torch.bool), s, torch.full_like(s, -np.inf))
    return s.numpy()


def _check(kind, k, splits, tps, n, precision="highest", step=1, m=2, dim=8,
           cap=None, mask=None, seed=None):
    qp, cp, cbp, mk = _operands(kind, m, n, dim,
                                seed=k + n if seed is None else seed,
                                precision=precision)
    mask = mk if mask is None else mask
    want_v, want_i = F.fused_topk_partial_plain(qp, cp, cbp, mask, k,
                                                precision, splits, tps)
    v, i = model_partial(_raw_scores(qp, cp, cbp, mask, precision), k,
                         splits, tps, step, cap)
    np.testing.assert_array_equal(v.view(np.int32),
                                  want_v.numpy().view(np.int32))
    np.testing.assert_array_equal(i, want_i.numpy())


def test_the_route_by_k():
    assert F.selection(F.INSERT_MAX_K) == "insert"
    assert F.selection(F.INSERT_MAX_K + 1) == "append"
    assert F.selection(F.APPEND_MAX_K) == "append"
    assert F.selection(CROSS) == "radix" == F.selection(F._MAX_FUSED_K)
    # A full buffer holds at least k entries (k >= 64), and a tile's 64
    # candidates fit after a select.
    assert CROSS >= 64
    for k in range(CROSS, F._MAX_FUSED_K + 1):
        assert F.radix_buffer(k) - 64 >= k


@pytest.mark.parametrize("k", KS)
def test_walk_equals_the_plain_version(k):
    """Seeded random scores: splits of 40 tiles (2560 rows: several selects
    at every k), of 9 (shorter than k from 1024 on) and of 2."""
    _check("random", k, splits=2, tps=40, n=5000)
    _check("random", k, splits=3, tps=9, n=1700)
    _check("random", k, splits=12, tps=2, n=1500)


@pytest.mark.parametrize("k", (CROSS, 512))
@pytest.mark.parametrize("kind", ["ties", "zero", "masked", "nonfinite"])
def test_walk_on_ties_zero_rows_masks_and_nonfinite(kind, k):
    _check(kind, k, splits=3, tps=24, n=4000, m=3,
           precision="bf16x3" if kind == "ties" else "highest")


@pytest.mark.parametrize("k", (CROSS, 1024))
def test_walk_on_short_and_one_tile_splits(k):
    _check("ties", k, splits=30, tps=1, n=1900, precision="bf16x3")
    _check("random", k, splits=1, tps=1, n=50)


def test_walk_on_zero_query_rows():
    qp, cp, cbp, _ = _operands("random", 0, 900, 8, 1, "highest")
    v, i = F.fused_topk_partial_plain(qp, cp, cbp, None, 300, "highest", 2,
                                      8)
    mv, mi = model_partial(_raw_scores(qp, cp, cbp, None, "highest"), 300,
                           2, 8)
    assert v.shape == mv.shape == (0, 2, 300) and i.shape == mi.shape


@pytest.mark.parametrize("k", (CROSS, 1024))
def test_walk_in_four_tile_steps(k):
    _check("random", k, splits=2, tps=37, n=4700, step=4)
    _check("ties", k, splits=2, tps=30, n=3800, step=4, precision="bf16x3")


@pytest.mark.parametrize("k,extra", [(CROSS, 0), (CROSS, 1), (256, 0),
                                     (256, 1)])
def test_walk_at_the_buffer_boundary(k, extra):
    """Full tiles then one partial tile that leave exactly 2k entries
    buffered (extra 0: no select until the next tile) or one entry past
    (extra 1: the select runs on that tile); the empty threshold takes
    every valid score."""
    cap = F.radix_buffer(k)
    full, part = divmod(cap + extra, F._TN)
    tps = full + 3
    n = 2 * tps * F._TN
    valid = np.ones(tps * F._TN, bool)
    valid[full * F._TN + part:(full + 1) * F._TN] = False
    mask = F.pad_mask_row(torch.from_numpy(np.tile(valid, 2)), n)
    stats = []
    qp, cp, cbp, _ = _operands("random", 2, n, 8, seed=k + extra,
                               precision="highest")
    want_v, want_i = F.fused_topk_partial_plain(qp, cp, cbp, mask, k,
                                                "highest", 2, tps)
    scores = _raw_scores(qp, cp, cbp, mask, "highest")
    v, i = model_partial(scores, k, 2, tps, stats=stats)
    np.testing.assert_array_equal(v.view(np.int32),
                                  want_v.numpy().view(np.int32))
    np.testing.assert_array_equal(i, want_i.numpy())
    # With the boundary tile the buffer holds cap + extra entries: a select
    # runs on it only when extra is 1, later otherwise; one a row a split
    # at least.
    assert len(stats) >= 4
    # The first select of the first row: with extra 0 the tile after the
    # boundary one set it off, with extra 1 the boundary tile itself.
    first = []
    model_partial(scores[:1, :(full + 1) * F._TN], k, 1, full + 1,
                  stats=first)
    assert len(first) == extra


def test_selects_stop_early_on_random_scores():
    """At canonical-like scores, the select isolates the k-th in a few
    passes of 7-bit digits, far below the 10 of a full 64-bit key."""
    r = np.random.default_rng(9)
    s = (r.standard_normal((2, 4096)) / 16).astype(np.float32)
    stats = []
    model_partial(s, 512, 2, 32, stats=stats)
    assert stats and max(stats) <= 5


def test_select_ties_at_the_kth_value_keep_the_lower_index():
    """Equal values at the k-th place (ones, signed zeros): the lower
    indices survive, and the threshold is that value, so later equal
    scores never enter."""
    k = CROSS
    s = np.full((1, 64 * 12), -1.0, np.float32)
    s[0, ::3] = 1.0
    s[0, 1::3] = -0.0
    s[0, 2::6] = 0.0
    v, i = model_partial(s, k, 1, 12)
    order = np.argsort(_keys(s[0], np.arange(s.shape[1])))[::-1][:k]
    np.testing.assert_array_equal(i[0, 0], order.astype(np.int32))
    np.testing.assert_array_equal(v[0, 0].view(np.int32),
                                  s[0, order].view(np.int32))


def test_the_network_sorts_every_length():
    r = np.random.default_rng(3)
    for n in (0, 1, 2, 31, 127, 128, 129, 300, 512, 1000, 1024):
        keys = r.integers(int(EMPTY) + 1, 2 ** 64, n, dtype=U)
        np.testing.assert_array_equal(flip_sort(keys), np.sort(keys)[::-1])


def _register_stage(a, m):
    """sort_stage<E, M> on a block held as a[lane][e] (block place lane *
    E + e): registers e and e ^ LO of a lane where M < E, else register e
    of lane ^ HI against this lane's register e ^ LO."""
    e_n = a.shape[1]
    hi, lo, hb = m // e_n, m % e_n, 1 << (m.bit_length() - 1)
    out = a.copy()
    for lane in range(32):
        for e in range(e_n):
            x = lane * e_n + e
            if hi == 0:
                if e & hb:
                    continue
                p, q = a[lane, e], a[lane, e ^ lo]
                out[lane, e], out[lane, e ^ lo] = max(p, q), min(p, q)
            else:
                lower = (lane & (hb // e_n)) == 0
                assert lower == ((x & hb) == 0)
                y = a[lane ^ hi, e ^ lo]   # the shuffle's value
                out[lane, e] = max(a[lane, e], y) if lower else min(
                    a[lane, e], y)
    return out


@pytest.mark.parametrize("e_n", (4, 8, 16))
def test_register_stages_are_the_network(e_n):
    """Every stage sort_block<E> runs, on the lanes' registers, equals the
    network's stage on the block's places (lane * E + e)."""
    r = np.random.default_rng(6)
    block = 32 * e_n
    a = r.integers(int(EMPTY) + 1, 2 ** 64, block, dtype=U)
    size = 2
    while size <= block:
        masks = [size - 1] + [size >> s for s in range(2, size.bit_length())]
        for m in masks:
            want = a.copy()
            _flip(want, m)
            got = _register_stage(a.reshape(32, e_n), m).reshape(-1)
            np.testing.assert_array_equal(got, want)
            a = want
        size *= 2
    np.testing.assert_array_equal(a, np.sort(a)[::-1])


def test_select_finds_the_kth_of_random_bits():
    r = np.random.default_rng(4)
    for n, k in ((256, CROSS), (1100, 550), (2048, 1024), (300, 299)):
        keys = np.unique(r.integers(int(EMPTY) + 1, 2 ** 64, n, dtype=U))
        r.shuffle(keys)
        kth, kept, passes = radix_select(keys, k)
        assert kth == np.sort(keys)[::-1][k - 1]
        np.testing.assert_array_equal(kept, keys[keys >= kth])
        assert 1 <= passes <= 10


# ---------------------------------------------------------------------------
# The plans: the radix selection keeps the carry's shared memory.
# ---------------------------------------------------------------------------

# Blocks an SM of kernel A's mma.sync / f32 consumers at the radix
# selection's k (tm 16 at every k, tm 32 up to 256, its envelope,
# query_tile_rows), dims 256 and 768: the appending selection's plans,
# unchanged.
RADIX_BLOCKS = {
    256: {16: {"highest": (2, 2, 2, 1), "bf16x3": (2, 2, 2, 1),
               "bf16c": (2, 2, 1, 1), "int8c": (2, 2, 1, 1),
               "int4c": (2, 2, 2, 1)},
          32: {"highest": (2, 2), "bf16x3": (2, 2), "bf16c": (2, 1),
               "int8c": (2, 2), "int4c": (2, 2)}},
    768: {16: {"highest": (2, 2, 2, 1), "bf16x3": (2, 2, 2, 1),
               "bf16c": (2, 2, 1, 1), "int8c": (2, 2, 1, 1),
               "int4c": (2, 2, 1, 1)},
          32: {"highest": (2, 2), "bf16x3": (2, 2), "bf16c": (2, 1),
               "int8c": (2, 2), "int4c": (2, 2)}},
}
PLAN_KS = {16: (CROSS, 256, 512, 1024), 32: (CROSS, 256)}


@pytest.mark.parametrize("dim", sorted(RADIX_BLOCKS))
def test_radix_plans_keep_their_blocks_an_sm(dim):
    for tm, by_core in RADIX_BLOCKS[dim].items():
        for core, blocks in by_core.items():
            c_ld = F._corpus_width(core, dim)
            got = []
            for k in PLAN_KS[tm]:
                stages, _, _, nbytes = F.stage_plan(tm, core, c_ld, k)
                assert stages >= 2 and nbytes <= F.MAX_SMEM, (tm, core, k)
                got.append(min(2, F._SMEM_PER_SM
                               // (nbytes + F._SMEM_PER_BLOCK)))
            assert tuple(got) == blocks, (tm, core)


@pytest.mark.parametrize("tm", (16, 32, 64))
def test_radix_state_fits_the_tail(tm):
    """Thresholds and counts (2 tm words) and tm x k 8-byte keys (8-byte
    aligned): within tail_bytes after the score tile, at every k."""
    tile = tm * (F._TN + 1) * 4
    assert (tile + 8 * tm) % 8 == 0
    for k in range(CROSS, F._MAX_FUSED_K + 1):
        assert tile + 8 * tm + 8 * tm * k <= F.tail_bytes(tm, k)


# ---------------------------------------------------------------------------
# The port against the JAX package above the crossover.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,n,dim,k", [(9, 1500, 40, CROSS),
                                       (20, 2200, 64, 1024)])
def test_topk_matches_jax_above_the_crossover(m, n, dim, k):
    r = np.random.default_rng(k)
    q = r.standard_normal((m, dim)).astype(np.float32)
    c = r.standard_normal((n, dim)).astype(np.float32)
    idx, scores = topk(q, c, k, "cosine", device="cpu")
    jidx, jscores = JAPI.topk(q, c, k, "cosine", config=JConfig(block_n=256))
    assert_topk_equivalent(np.asarray(idx), np.asarray(scores),
                           np.asarray(jidx), np.asarray(jscores))
