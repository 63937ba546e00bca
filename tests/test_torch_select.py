"""Kernel A's selection at k > 16: the exact keys, a step-by-step model of
the append / compact walk, the plans beside it, and the port against the
JAX package at such k.

Kernel A cannot run here.  Its selection (``csrc/fused_topk.cu``) orders
candidates on 64-bit keys (``sel_key``), mirrored on the host by
``fused_topk.select_keys``; the first tests hold the mirror to the float
order with lowest-index ties and to a lossless round trip.  The model
below repeats the kernel's walk step by step in NumPy (the threshold, the
ballot's append order, the compaction of the slack with a tile's
candidates, the bitonic network over registers ``e * 32 + lane`` and the
chunked merge into the carry, with the same strides, partners and early
stops as the source) and must give ``fused_topk_partial_plain``'s split
lists bit for bit: on seeded random scores, integer tie data, zero query
rows, masked rows and wholly masked splits, at k from 17 to 1024
and several slack sizes.  Then the plans: the appending selection keeps
the insertion's shared memory, so every (core, query tile, k) keeps the
blocks an SM it had with the insertion alone (the literals below).  Last, the same seeded NumPy inputs through
the JAX package's ``fused_topk`` (its Pallas kernel in interpret mode, as
its own tests run it) and through the port on the CPU, held to
``assert_topk_equivalent``'s tolerance (rtol 2e-5, atol 8e-6: both sides
sum the three bf16 products in f32, in their own order).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polars_matmul_tpu.config import SearchConfig as JConfig
from polars_matmul_tpu_torch import SearchConfig, topk
from polars_matmul_tpu_torch.kernels import fused_topk as F

from conftest import assert_topk_equivalent

JF = importlib.import_module("polars_matmul_tpu.kernels.fused_topk")
JAPI = importlib.import_module("polars_matmul_tpu.api.search")

torch.set_num_threads(2)

EMPTY = F.EMPTY_KEY
KS = (17, 32, 33, 100, 128, 129, 256, 512, 1024)


def _keys(v, i):
    return F.select_keys(torch.as_tensor(v, dtype=torch.float32),
                         torch.as_tensor(i, dtype=torch.int32)).numpy()


# ---------------------------------------------------------------------------
# The keys.
# ---------------------------------------------------------------------------


def test_keys_follow_the_float_order_then_the_lower_index():
    r = np.random.default_rng(0)
    v = np.concatenate([
        r.standard_normal(300).astype(np.float32),
        np.array([0.0, -0.0, 1e-45, -1e-45, 1.1754942e-38, -1.1754942e-38,
                  np.inf, 3.4e38, -3.4e38], np.float32),
        r.integers(-3, 4, 200).astype(np.float32)])
    i = r.permutation(len(v)).astype(np.int32)
    key = _keys(v, i)
    better = (v[:, None] > v[None, :]) | (
        (v[:, None] == v[None, :]) & (i[:, None] < i[None, :]))
    np.testing.assert_array_equal(key[:, None] > key[None, :], better)
    assert len(set(key.tolist())) == len(v)   # distinct indices: distinct
    assert (key > EMPTY).all()


@pytest.mark.parametrize("value", [0.0, -0.0, 1e-45, -1e-45, 2.0 ** -126,
                                   -(2.0 ** -126), np.inf, -1.5])
def test_keys_give_back_the_value_bits_and_the_index(value):
    v = np.full(4, value, np.float32)
    i = np.array([0, 1, 12345, 2 ** 31 - 1], np.int32)
    key = torch.from_numpy(_keys(v, i))
    np.testing.assert_array_equal(
        F.key_values(key).numpy().view(np.int32), v.view(np.int32))
    np.testing.assert_array_equal(F.key_indices(key).numpy(), i)


def test_signed_zeros_tie_and_the_lower_index_wins():
    key = _keys([-0.0, 0.0, -0.0, 0.0], [3, 4, 9, 1])
    assert list(np.argsort(-key, kind="stable")) == [3, 0, 1, 2]


def test_random_bits_round_trip():
    r = np.random.default_rng(1)
    bits = r.integers(-2 ** 31, 2 ** 31, 5000, dtype=np.int64).astype(
        np.int32)
    v = bits.view(np.float32)
    v = v[~np.isnan(v)]
    i = r.integers(0, 2 ** 31 - 1, len(v)).astype(np.int32)
    key = torch.from_numpy(_keys(v, i))
    np.testing.assert_array_equal(
        F.key_values(key).numpy().view(np.int32), v.view(np.int32))
    np.testing.assert_array_equal(F.key_indices(key).numpy(), i)


def test_empty_key_is_the_empty_slot_and_below_every_real_key():
    assert _keys([-np.inf], [2 ** 31 - 1])[0] == EMPTY
    assert _keys([-np.inf], [0])[0] > EMPTY
    assert _keys([-3.4e38], [2 ** 31 - 1])[0] > EMPTY


# ---------------------------------------------------------------------------
# The model of the walk (``append_tile``, ``compact``, ``merge_into_carry``
# and ``carry_out`` in csrc/fused_topk.cu).  Keys are int64 (the source's
# less 2^63); a register array a[E] of the warp is an (E, 32) array, key
# e * 32 + lane at [e, lane].
# ---------------------------------------------------------------------------


def _stage(a, size, stride):
    """key_stage<E, SIZE, STRIDE>."""
    lane = np.arange(32)
    if stride >= 32:
        r = stride // 32
        for e in range(a.shape[0]):
            if e & r:
                continue
            best_first = ((e * 32) & size) == 0
            x, y = a[e].copy(), a[e + r].copy()
            swap = x < y if best_first else y < x
            a[e], a[e + r] = np.where(swap, y, x), np.where(swap, x, y)
    else:
        low = (lane & stride) == 0
        for e in range(a.shape[0]):
            best_first = ((e * 32 + lane) & size) == 0
            y = a[e][lane ^ stride]
            a[e] = np.where((a[e] > y) == (low == best_first), a[e], y)


def _merge(a, size, stride):
    """key_merge<E, SIZE, STRIDE>."""
    while stride > 0:
        _stage(a, size, stride)
        stride //= 2


def _sort(a):
    """key_sort<E>."""
    size = 2
    while size <= a.size:
        _merge(a, size, size // 2)
        size *= 2


def _merge_into_carry(carry, a):
    """merge_into_carry<E>: carry (k,) keys, sorted best first."""
    k, p = len(carry), a.size
    top = a[0, 0]
    if top == EMPTY:
        return
    pos, hi = 0, k
    while pos < hi:
        mid = (pos + hi) // 2
        if carry[mid] > top:
            pos = mid + 1
        else:
            hi = mid
    x = np.arange(p).reshape(a.shape)
    while pos < k:
        src = pos + p - 1 - x
        b = np.where(src < k, carry[np.minimum(src, k - 1)], EMPTY)
        a, b = np.maximum(a, b), np.minimum(a, b)
        _merge(a, 2 * p, p // 2)
        dst = pos + x
        carry[dst[dst < k]] = a[dst < k]
        if pos + p >= k or not (b != EMPTY).any():
            break
        _merge(b, 2 * p, p // 2)
        a = b
        pos += p


def _compact(carry, slack, tile, lanes):
    """compact_row<lanes>: the tile's candidates (tile = (s (64,) f32, c
    (64,) candidates, n0), or None) and the slack's keys in batches of 32
    lanes keys (the tile and the slack's first 32 lanes - 64, then the
    next 32 lanes), each sorted and merged into the carry."""
    first = 0
    while True:
        a = np.full((lanes, 32), EMPTY, np.int64)
        p = 32 * lanes
        take, base = (p, 0) if tile is None else (p - 64, 64)
        if tile is not None:
            s, c, n0 = tile
            a[:2] = np.where(c, _keys(s, n0 + np.arange(64)),
                             EMPTY).reshape(2, 32)
        batch = slack[first:first + take]
        flat = a.reshape(-1)
        flat[base:base + len(batch)] = batch
        _sort(a)
        assert (flat[:-1] >= flat[1:]).all()
        _merge_into_carry(carry, a)
        first += take
        tile = None
        if first >= len(slack):
            break


def model_partial(scores, k, splits, tps, cap, step=1, lanes=4):
    """The appending selection's split lists of (m, n) f32 scores: each
    split's tiles in walk order (``step`` tiles a step, as the highest
    core's and the warpgroup consumer's walks take them), slack of
    ``cap`` entries a row, compaction batches of 32 ``lanes`` keys."""
    m, n = scores.shape
    n_tiles = -(-n // F._TN)
    pad = np.full((m, splits * tps * F._TN), -np.inf, np.float32)
    pad[:, :n] = scores
    out_v = np.empty((m, splits, k), np.float32)
    out_i = np.empty((m, splits, k), np.int32)
    for row in range(m):
        for sp in range(splits):
            carry = np.full(k, EMPTY, np.int64)
            slack = []
            t_begin, t_end = sp * tps, min(n_tiles, (sp + 1) * tps)
            for t0 in range(t_begin, t_end, step):
                for t in range(t0, min(t0 + step, t_end)):
                    n0 = t * F._TN
                    s = pad[row, n0:n0 + F._TN]
                    kth = F.key_values(torch.tensor([carry[-1]])).item()
                    c = s > np.float32(kth)
                    if not c.any():
                        continue
                    if len(slack) + int(c.sum()) > cap:
                        _compact(carry, np.array(slack, np.int64),
                                 (s, c, n0), lanes)
                        slack = []
                    else:   # lanes in order, the first half, then the next
                        slack += list(_keys(s[c], n0 + np.flatnonzero(c)))
            if slack:
                _compact(carry, np.array(slack, np.int64), None, lanes)
            key = torch.from_numpy(carry)
            out_v[row, sp] = F.key_values(key).numpy()
            out_i[row, sp] = F.key_indices(key).numpy()
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
    qt, ct = torch.from_numpy(q), torch.from_numpy(c)
    qp = F.prepare_queries(qt, metric, precision)
    cp, cbp = F.prepare_corpus(ct, metric, precision=precision)
    mask = None
    if kind == "masked":   # random rows, and the second split wholly
        keep = r.random(n) < 0.6
        keep[n // 3: 2 * n // 3] = False
        mask = F.pad_mask_row(torch.from_numpy(keep), n)
    return qp, cp, cbp, mask


def _check_model(kind, k, cap, splits, tps, n, precision="highest", step=1,
                 m=2, dim=8, lanes=4):
    qp, cp, cbp, mask = _operands(kind, m, n, dim, seed=k + cap + n,
                                  precision=precision)
    want_v, want_i = F.fused_topk_partial_plain(qp, cp, cbp, mask, k,
                                                precision, splits, tps)
    scores = F._masked_scores(qp, cp, cbp, mask, precision, 0, n).numpy()
    v, i = model_partial(scores, k, splits, tps, cap, step, lanes)
    np.testing.assert_array_equal(v.view(np.int32),
                                  want_v.numpy().view(np.int32))
    np.testing.assert_array_equal(i, want_i.numpy())


@pytest.mark.parametrize("k", KS)
def test_walk_equals_the_plain_version(k):
    """Seeded random scores, at the kernel's slack and three others; splits
    of 9 tiles (576 rows: shorter than k from 1024 on) and of 2."""
    for cap in sorted({F.slack_entries(k), min(k, 192), 17, 0}):
        _check_model("random", k, cap, splits=3, tps=9, n=1700)
        _check_model("random", k, cap, splits=12, tps=2, n=1500)


@pytest.mark.parametrize("k", (17, 100, 129, 512))
@pytest.mark.parametrize("kind", ["ties", "zero", "masked"])
def test_walk_on_ties_zero_rows_and_masks(kind, k):
    _check_model(kind, k, F.slack_entries(k), splits=4, tps=6, n=1400,
                 precision="highest" if kind != "ties" else "bf16x3")


@pytest.mark.parametrize("k", (33, 128, 1024))
def test_walk_in_four_tile_steps(k):
    _check_model("random", k, F.slack_entries(k), splits=3, tps=9, n=1700,
                 step=4)
    _check_model("ties", k, 17, splits=2, tps=12, n=1500, step=4,
                 precision="bf16x3")


@pytest.mark.parametrize("k", (17, 100, 256))
def test_walk_in_batches_of_64_keys(k):
    """The int4 core at query tile 32 compacts 64 keys at a time."""
    assert F.compact_lanes(32, "int4c") == 2
    assert {F.compact_lanes(tm, c) for tm in (16, 32, 64)
            for c in F.CORES if (tm, c) != (32, "int4c")} == {4}
    for cap in sorted({F.slack_entries(k), 17, 0}):
        _check_model("random", k, cap, splits=3, tps=9, n=1700, lanes=2)
    _check_model("ties", k, F.slack_entries(k), splits=2, tps=12, n=1500,
                 precision="bf16x3", lanes=2)


@pytest.mark.parametrize("cap", (0, 17, 36, 63, 64, 99, 100, 101))
def test_walk_at_the_slack_boundary(cap):
    """A tile of 64 candidates (the empty carry takes all), then a tile of
    36 under a mask: a slack of 100 takes both exactly, 99 compacts on the
    second, 63 on the first."""
    n, k = 64 * 4, 100
    qp, cp, cbp, _ = _operands("random", 2, n, 8, seed=cap,
                               precision="highest")
    keep = np.ones(n, bool)
    keep[64 + 36:128] = False
    mask = F.pad_mask_row(torch.from_numpy(keep), n)
    want_v, want_i = F.fused_topk_partial_plain(qp, cp, cbp, mask, k,
                                                "highest", 1, 4)
    scores = F._masked_scores(qp, cp, cbp, mask, "highest", 0, n).numpy()
    v, i = model_partial(scores, k, 1, 4, cap)
    np.testing.assert_array_equal(v.view(np.int32),
                                  want_v.numpy().view(np.int32))
    np.testing.assert_array_equal(i, want_i.numpy())


def test_walk_keeps_signed_zeros_and_never_takes_nan_or_minus_inf():
    """Scores of +-0.0, NaN and -inf: the zeros in index order with their
    signs, NaN and -inf never entering (the slots past them empty)."""
    r = np.random.default_rng(5)
    s = np.where(r.random((3, 700)) < 0.5, np.float32(-0.0),
                 np.float32(0.0)).astype(np.float32)
    s[:, ::7] = np.nan
    s[:, 3::7] = -np.inf
    s[1, 100:200] = 1.0
    k = 512
    v, i = model_partial(s, k, 1, 11, F.slack_entries(k))
    for row in range(3):
        ok = ~np.isnan(s[row]) & (s[row] != -np.inf)
        key = _keys(s[row][ok], np.flatnonzero(ok))
        order = np.argsort(-key, kind="stable")[:k]
        n_real = len(order)
        np.testing.assert_array_equal(
            v[row, 0, :n_real].view(np.int32),
            s[row][ok][order].view(np.int32))
        np.testing.assert_array_equal(i[row, 0, :n_real],
                                      np.flatnonzero(ok)[order])
        assert (v[row, 0, n_real:] == -np.inf).all()
        assert (i[row, 0, n_real:] == F.INT32_MAX).all()


def test_network_sorts_and_merges_every_register_count():
    r = np.random.default_rng(3)
    for e in (1, 2, 4, 8):
        a = r.integers(-2 ** 62, 2 ** 62, (e, 32))
        want = np.sort(a.reshape(-1))[::-1]
        _sort(a)
        np.testing.assert_array_equal(a.reshape(-1), want)
        carry = np.sort(r.integers(-2 ** 62, 2 ** 62, 300))[::-1].copy()
        union = np.sort(np.concatenate([carry, a.reshape(-1)]))[::-1]
        _merge_into_carry(carry, a)
        np.testing.assert_array_equal(carry, union[:300])


# ---------------------------------------------------------------------------
# The plans: the selection keeps the insertion's shared memory, so every
# (core, query tile, k) fits and keeps its blocks an SM.
# ---------------------------------------------------------------------------

# The first k (of each query tile's envelope, query_tile_rows) at which
# the plan keeps one block an SM, as with the insertion alone (absent: two
# at every k); the warpgroup consumer (the stored cores at tile 64)
# always one.
ONE_BLOCK_FROM = {
    3: {("highest", 16): 642, ("bf16x3", 16): 676, ("bf16x3", 64): 110,
        ("bf16c", 16): 480, ("int8c", 16): 432, ("int4c", 16): 560},
    256: {("highest", 16): 636, ("highest", 64): 114, ("bf16x3", 16): 656,
          ("bf16x3", 64): 110, ("bf16c", 16): 416, ("bf16c", 32): 244,
          ("int8c", 16): 432, ("int4c", 16): 560},
    768: {("highest", 16): 636, ("highest", 64): 114, ("bf16x3", 16): 656,
          ("bf16x3", 64): 110, ("bf16c", 16): 408, ("bf16c", 32): 244,
          ("int8c", 16): 296, ("int4c", 16): 424},
}


@pytest.mark.parametrize("dim", sorted(ONE_BLOCK_FROM))
@pytest.mark.parametrize("core", F.CORES)
def test_every_plan_fits_and_keeps_its_blocks_an_sm(core, dim):
    c_ld = F._corpus_width(core, dim)
    for tm, top in ((16, 1024), (32, 256), (64, 128)):
        first = 1 if F.wgmma_core(tm, core) else ONE_BLOCK_FROM[dim].get(
            (core, tm))
        for k in range(1, top + 1):
            stages, _, _, nbytes = F.stage_plan(tm, core, c_ld, k)
            assert stages >= 2 and nbytes <= F.MAX_SMEM, (tm, k)
            blocks = 1 if F.wgmma_core(tm, core) else min(
                2, F._SMEM_PER_SM // (nbytes + F._SMEM_PER_BLOCK))
            want = 1 if first is not None and k >= first else 2
            assert blocks == want, (tm, k, blocks)


def test_slack_fits_the_output_rows_and_the_registers():
    for k in range(F.INSERT_MAX_K + 1, F._MAX_FUSED_K + 1):
        s = F.slack_entries(k)
        assert 1 <= s <= k and 64 + s <= 256
        # A compaction with a tile fills its keys' registers where k allows.
        assert s in (64, 192) or s == k < 64
    # The slack's counts take the insertion's merge lists' place.
    assert 64 * 4 <= F.tail_bytes(64, 1) - 64 * (F._TN + 1) * 4 - 64 * 8


# ---------------------------------------------------------------------------
# The port against the JAX package at k above 16.
# ---------------------------------------------------------------------------


def _data(m, n, dim, seed):
    r = np.random.default_rng(seed)
    return (r.standard_normal((m, dim)).astype(np.float32),
            r.standard_normal((n, dim)).astype(np.float32))


@pytest.mark.parametrize("m,n,dim,k", [(9, 700, 5, 17), (37, 1000, 257, 100),
                                       (20, 1300, 64, 129),
                                       (9, 1500, 96, 512)])
def test_topk_matches_jax_above_k_16(m, n, dim, k):
    q, c = _data(m, n, dim, seed=k)
    idx, scores = topk(q, c, k, "cosine", device="cpu")
    jidx, jscores = JAPI.topk(q, c, k, "cosine",
                              config=JConfig(block_n=256))
    assert_topk_equivalent(np.asarray(idx), np.asarray(scores),
                           np.asarray(jidx), np.asarray(jscores))


@pytest.mark.parametrize("k", (17, 100, 129, 512))
def test_fused_topk_matches_jax_interpret(k):
    q, c = _data(20, 900, 40, seed=k + 1)
    pv, pi = F.fused_topk(torch.from_numpy(q), torch.from_numpy(c), k,
                          "dot", config=SearchConfig())
    jv, ji = JF.fused_topk(jnp.asarray(q), jnp.asarray(c), k, "dot",
                           config=JConfig(block_n=256, precision="bf16x3"),
                           interpret=True)
    assert_topk_equivalent(pi.numpy(), pv.numpy(), np.asarray(ji),
                           np.asarray(jv))
