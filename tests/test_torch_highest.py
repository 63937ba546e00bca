"""Kernel A's "highest" core: the f32 ring's plan and register tiles, and
the port's exact f32 path against the JAX package.

Kernel A cannot run here.  The first half checks what the host decides
for it (``fused_topk.f32_plan``, the mirror of ``f32_plan`` in
``csrc/fused_topk.cu``: stages, bytes a stage, the query tile resident or
riding the stages) and a NumPy model of the consumer's layout (every
score of a step owned once, the rows of each 16-byte shared read on
distinct banks, the FMA a distinct byte read).  The second half sends the
same seeded NumPy inputs through the JAX package's ``fused_topk`` with
``precision="highest"`` (its Pallas kernel in interpret mode, as its own
tests run it) and through the port on the CPU, where kernel A's wrapper
runs its plain version, held to ``assert_topk_equivalent``'s tolerance
(rtol 2e-5, atol 8e-6: both sides sum f32 products in their own order).
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

DIMS = (1, 3, 4, 5, 256, 257, 768, 1536, 4096)
# Each query tile's k envelope (query_tile_rows).
ENVELOPE = {64: (1, 10, 100, 128), 32: (1, 10, 100, 128, 256),
            16: (1, 10, 100, 128, 256, 512, 1024)}
PLANS = [(tm, k) for tm, ks in ENVELOPE.items() for k in ks]


def _blocks(nbytes):
    return F._SMEM_PER_SM // (nbytes + F._SMEM_PER_BLOCK)


def _staging(tm, dim, k, resident, stages):
    return (stages * F.f32_stage_bytes(tm, resident) + F.tail_bytes(tm, k)
            + (tm * F.f32_query_stride(tm, dim) if resident else 0))


# ---------------------------------------------------------------------------
# The plan.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("tm,k", PLANS)
def test_plan_fits_and_follows_its_rule(tm, k, dim):
    """Every plan fits a block; the query tile stays resident exactly where
    a resident plan keeps the most blocks an SM (two at most) any plan
    keeps, and the plan takes the most stages that keep both."""
    stages, stage, resident, smem = F.f32_plan(tm, dim, k)
    assert 2 <= stages <= F.F32_STAGES and smem <= F.MAX_SMEM
    assert smem == _staging(tm, dim, k, resident, stages)
    assert stage == F.f32_stage_bytes(tm, resident)

    def blocks(res):
        return max((min(_blocks(_staging(tm, dim, k, res, s)), 2)
                    for s in range(2, F.F32_STAGES + 1)
                    if _staging(tm, dim, k, res, s) <= F.MAX_SMEM),
                   default=0)

    best = max(blocks(True), blocks(False))
    assert min(_blocks(smem), 2) == best
    assert resident == (blocks(True) == best)
    for more in range(stages + 1, F.F32_STAGES + 1):
        nbytes = _staging(tm, dim, k, resident, more)
        assert nbytes > F.MAX_SMEM or min(_blocks(nbytes), 2) < best


@pytest.mark.parametrize("tm", (16, 32, 64))
def test_stage_rows_are_odd_16_byte_units(tm):
    """A stage is the step's 4096 / tm corpus rows (and tm query rows when
    the query rides), each 32, 16 or 8 features at an odd number of
    16-byte units; a resident query row too, at every dim."""
    rows = F.f32_step_rows(tm)
    assert rows * tm == 4096 and F.f32_cols(tm) == {64: 32, 32: 16, 16: 8}[tm]
    stride = F.f32_stage_bytes(tm, True) // rows
    assert stride * rows == F.f32_stage_bytes(tm, True)
    assert stride >= 4 * F.f32_cols(tm) and (stride // 16) % 2 == 1
    assert stride % 16 == 0
    assert F.f32_stage_bytes(tm, False) == (rows + tm) * stride
    for dim in DIMS:
        qs = F.f32_query_stride(tm, dim)
        assert qs % 16 == 0 and (qs // 16) % 2 == 1 and qs >= 4 * dim
        assert qs - 4 * F.f32_cols(tm) * -(-dim // F.f32_cols(tm)) in (0, 16)


@pytest.mark.parametrize("k,resident,stages,blocks", [
    (10, True, 2, 2), (100, False, 2, 2), (128, True, 4, 1)])
def test_canonical_plans(k, resident, stages, blocks):
    """At the canonical 256 dims and query tile 64: the query tile stays
    resident at k = 10 and rides at k = 100 (resident, the carry would
    leave one block an SM); at k = 128 no plan keeps two, and the
    resident tile takes the stages one block leaves."""
    got = F.f32_plan(64, 256, k)
    assert got[0] == stages and got[2] == resident
    assert _blocks(got[3]) == blocks


def test_two_blocks_an_sm_below_each_tiles_k_limit():
    """Two blocks an SM up to k = 113 at tm 64, 256 at tm 32 and 635 at
    tm 16 (canonical k = 512), for every dim; one above."""
    for tm, top in ((64, 113), (32, 256), (16, 635)):
        for dim in DIMS:
            assert _blocks(F.f32_plan(tm, dim, top)[3]) >= 2, (tm, dim)
        assert _blocks(F.f32_plan(tm, 256, top + 1)[3]) == 1 or tm == 32


def test_stage_plan_routes_highest_to_the_f32_ring():
    assert F.stage_plan(64, "highest", 256, 10) == F.f32_plan(64, 256, 10)
    assert F.stage_plan(16, "highest", 768, 512) == F.f32_plan(16, 768, 512)


def test_canonical_geometry_gives_kernel_b_sixteen_lists():
    """Two blocks an SM on 132 SMs: canonical k=10 cuts the 157 tiles into
    16 splits of 10 (the lists kernel B merges: 1000 x 16 x 10)."""
    assert F.launch_geometry(1000, 10_000, 10, 132, 2) == (64, 16, 10)


# ---------------------------------------------------------------------------
# The consumer's layout (fused_topk_f32_kernel, f32_products).
# ---------------------------------------------------------------------------


def _owners(tm):
    """(query row, step row) -> threads computing it, and each lane's
    rows: warp w, lane (lq, lc) own query rows 16 (w % WQ) + lq + 4 i and
    step rows 32 (w / WQ) + lc + 8 j, i, j < 4 (WQ = tm / 16)."""
    wq = tm // 16
    owners = {}
    rows = {}
    for w in range(8):
        for lane in range(32):
            qr = [16 * (w % wq) + lane // 8 + 4 * i for i in range(4)]
            cr = [32 * (w // wq) + lane % 8 + 8 * j for j in range(4)]
            rows[(w, lane)] = (qr, cr)
            for a in qr:
                for b in cr:
                    owners.setdefault((a, b), []).append((w, lane))
    return owners, rows


@pytest.mark.parametrize("tm", (16, 32, 64))
def test_every_score_of_a_step_has_one_owner(tm):
    owners, rows = _owners(tm)
    step = F.f32_step_rows(tm)
    assert set(owners) == {(a, b) for a in range(tm) for b in range(step)}
    assert all(len(v) == 1 for v in owners.values())
    # A warp's rows lie in one kernel tile (the warps of tile j write its
    # scores into the one score tile).
    for (w, lane), (_, cr) in rows.items():
        assert len({b // F._TN for b in cr}) == 1


@pytest.mark.parametrize("tm", (16, 32, 64))
@pytest.mark.parametrize("resident", (True, False))
def test_reads_hit_distinct_banks_and_reuse_bytes(tm, resident):
    """Each 16-byte read of a warp: its distinct rows fall on distinct
    16-byte bank groups (row stride an odd number of units); every four
    features a warp does 2048 FMA on 768 distinct bytes it reads (2.7 a
    byte; the per-tile micro-tile did 0.5 at tm 64)."""
    _, rows = _owners(tm)
    cstride = F.f32_stage_bytes(tm, True) // F.f32_step_rows(tm)
    qstride = F.f32_query_stride(tm, 768) if resident else cstride
    for w in range(8):
        distinct = 0
        for which, stride in ((0, qstride), (1, cstride)):
            for r in range(4):
                picked = {rows[(w, lane)][which][r] for lane in range(32)}
                units = {(row * stride // 16) % 8 for row in picked}
                assert len(units) == len(picked) <= 8
                distinct += 16 * len(picked)
        assert distinct == 768
        assert 32 * 16 * 4 / distinct >= 2.0


# ---------------------------------------------------------------------------
# The port's exact f32 path against the JAX package.
# ---------------------------------------------------------------------------


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _data(m, n, dim, seed):
    r = np.random.default_rng(seed)
    return (r.standard_normal((m, dim)).astype(np.float32),
            r.standard_normal((n, dim)).astype(np.float32))


# Ragged dims (not a multiple of 4, one below a 16-byte piece), n a
# multiple of no tile, query tiles 16, 32 and 64, k up to 512.
DENSE = [
    (5, 333, 1, 1, "cosine", False),
    (37, 700, 3, 10, "dot", True),
    (20, 1100, 5, 100, "euclidean", False),
    (65, 333, 257, 100, "cosine", True),
    (9, 1300, 255, 512, "dot", False),
    (40, 700, 4, 256, "cosine", True),
]


@pytest.mark.parametrize("m,n,dim,k,metric,masked", DENSE)
def test_highest_matches_jax(m, n, dim, k, metric, masked):
    q, c = _data(m, n, dim, seed=dim + k)
    mask = (np.arange(n) % 3 != 1) if masked else None
    cfg = dict(precision="highest")
    before = dict(F.core_launches)
    pv, pi = F.fused_topk(_t(q), _t(c), k, metric,
                          mask=None if mask is None else _t(mask),
                          config=SearchConfig(**cfg))
    assert F.core_launches == before   # the CPU runs the plain version
    jv, ji = JF.fused_topk(jnp.asarray(q), jnp.asarray(c), k, metric,
                           mask=None if mask is None else jnp.asarray(mask),
                           config=JConfig(block_n=256, **cfg))
    assert_topk_equivalent(pi.numpy(), pv.numpy(), np.asarray(ji),
                           np.asarray(jv))


# (m, n, dim, k): one list of three layout tiles a query block, the last
# layout tile (ragged) on every list, one id past the corpus on the last.
LISTED = [(20, 1000, 5, 10), (70, 1300, 257, 100), (20, 1100, 3, 512)]


@pytest.mark.parametrize("m,n,dim,k", LISTED)
def test_listed_highest_matches_jax(m, n, dim, k):
    q, c = _data(m, n, dim, seed=n + k)
    jcfg = JConfig(block_n=256, precision="highest")
    tn = JF.corpus_tile_rows(dim, jcfg, k)
    tm = JF.query_tile_rows(m, dim, jcfg, k)
    jcp, jcbp = JF.prepare_corpus(jnp.asarray(c), "dot", tn=tn,
                                  precision="highest")
    cp, cbp = F.prepared_from_jax(np.asarray(jcp), np.asarray(jcbp), n, dim)
    n_layout = -(-n // tn)
    r = np.random.default_rng(k)
    tiles = np.stack([np.sort(np.append(
        r.choice(n_layout - 1, 2, replace=False), n_layout - 1))
        for _ in range(-(-m // tm))]).astype(np.int32)
    jv, ji = JF.fused_topk_prepared(jnp.asarray(q), jcp, jcbp, k, "dot",
                                    tn=tn, config=jcfg, interpret=True,
                                    tiles=jnp.asarray(tiles))
    pv, pi = F.fused_topk_prepared(_t(q), cp, cbp, k, "dot",
                                   config=SearchConfig(block_n=256),
                                   precision="highest", tiles=tiles, tn=tn)
    assert_topk_equivalent(pi.numpy(), pv.numpy(), np.asarray(ji),
                           np.asarray(jv))
    # A list past the corpus names no rows: the port's kernel path takes
    # it (the JAX package refuses such ids); its rows are the list's
    # others.
    past = tiles.copy()
    past[-1, -1] = n_layout + 3
    pv2, pi2 = F.fused_topk_prepared(_t(q), cp, cbp, k, "dot",
                                     config=SearchConfig(block_n=256),
                                     precision="highest", tiles=past, tn=tn)
    last = pi2.numpy()[(len(tiles) - 1) * tm:]
    live = last[last != F.INT32_MAX]
    assert np.isin(live // tn, past[-1, :-1]).all()


@pytest.mark.parametrize("m,n,dim,k", [(37, 1000, 257, 10), (8, 700, 3, 100)])
def test_topk_entry_matches_jax_at_highest(m, n, dim, k):
    """The slice as a whole: ``topk`` from NumPy with precision="highest"
    on the CPU against the JAX package's ``topk``."""
    q, c = _data(m, n, dim, seed=m)
    idx, scores = topk(q, c, k, "cosine",
                       config=SearchConfig(precision="highest"),
                       device="cpu")
    jidx, jscores = JAPI.topk(q, c, k, "cosine",
                              config=JConfig(block_n=256,
                                             precision="highest"))
    assert_topk_equivalent(np.asarray(idx), np.asarray(scores),
                           np.asarray(jidx), np.asarray(jscores))
