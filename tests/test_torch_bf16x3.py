"""Kernel A's "bf16x3" core (the default precision) on the ring: its plans,
a model of the ring's k order, the tile-64 consumer rule, and the port's
bf16x3 path against the JAX package.

Kernel A cannot run here.  The first half checks what the host decides
for it (``fused_topk.stage_plan``, the mirror of ``ring_plan`` /
``wg_plan`` in ``csrc/tile_scores.cuh`` and ``csrc/ring_wgmma.cuh``) and
NumPy models of where the ring puts each byte of a [hi | lo] corpus row
and which feature every k slot of the products then holds: the mma.sync
consumer must keep the per-tile core's slots (``scores_bf16x3``: slot j of
a k16 step is feature 16 s + j), so that its scores are that core's bit
for bit.  The second half sends the same seeded NumPy inputs through the
JAX package's ``fused_topk`` (its Pallas kernel in interpret mode, as its
own tests run it) and through the port on the CPU, where kernel A's
wrapper runs its plain version, held to ``assert_topk_equivalent``'s
tolerance (rtol 2e-5, atol 8e-6: both sides sum the three bf16 products
in f32, in their own order).
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

DIMS = (1, 3, 8, 255, 256, 257, 768)
# Each query tile's k envelope (query_tile_rows): 1..128, 1..256, 1..1024.
TOP_K = {64: 128, 32: 256, 16: 1024}
# The largest k at which the mma.sync ring keeps two blocks an SM at every
# dim of DIMS: two stages riding beside the carry (the per-tile staging it
# replaced kept two up to k = 145, 343 and 739).
TWO_BLOCKS = {64: 109, 32: 256, 16: 655}
# The largest k at which query tiles 16 and 64 take the 64-feature ring
# ("bf16x3w") at dims of 255 and up (two blocks an SM with it); tile 32
# never does.
WIDE_K = {16: 495, 64: 45}
HILO = ("bf16x3", "bf16x3w")


def _blocks(nbytes):
    return F._SMEM_PER_SM // (nbytes + F._SMEM_PER_BLOCK)


# ---------------------------------------------------------------------------
# The plans.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("tm", (16, 32, 64))
def test_mma_ring_plan_over_the_envelope(tm, dim):
    """Every k a query tile takes has a ring of at least two stages that
    fits a block; two blocks an SM up to TWO_BLOCKS[tm]; the plan is
    ring_plan's beside the mma.sync tail (tile 64 included), of the
    64-feature ring exactly where that one keeps two blocks an SM at tiles
    16 and 64."""
    c_ld = 2 * dim
    for k in range(1, TOP_K[tm] + 1):
        tail = F.tail_bytes(tm, k)
        core = F.ring_core(tm, "bf16x3", c_ld, k)
        wide = F.ring_plan(tm, "bf16x3w", c_ld, tail)
        assert (core == "bf16x3w") == (
            tm != 32 and wide[0] >= 2 and _blocks(wide[3]) >= 2), k
        if dim >= 255:
            assert (core == "bf16x3w") == (k <= WIDE_K.get(tm, 0)), k
        plan = F.stage_plan(tm, "bf16x3", c_ld, k)
        stages, stage, resident, smem = plan
        assert 2 <= stages <= F.ring_stages(tm, core) and (
            smem <= F.MAX_SMEM), k
        assert plan == F.ring_plan(tm, core, c_ld, tail)
        assert (stage, smem - tail) == F.ring_staging(
            tm, core, c_ld, resident, stages)
        if k <= TWO_BLOCKS[tm]:
            assert _blocks(smem) >= 2, k


@pytest.mark.parametrize("core,cols,row,qrow", [
    ("bf16x3", 32, 144, 80), ("bf16x3w", 64, 272, 144)])
def test_mma_ring_stage_bytes(core, cols, row, qrow):
    """32 (64) features a position: 64 rows of 128 (256) bytes, hi then
    lo, at a stride of an odd number of 16-byte units, then, riding, the
    hi and lo query columns at such a stride too."""
    for tm in (16, 32, 64):
        assert F.ring_row_bytes(tm, core) == 4 * cols
        assert F.ring_cols(tm, core) == cols
        stage, staging = F.ring_staging(tm, core, 512, False, 2)
        assert stage == 64 * row + 2 * tm * qrow and staging == 2 * stage
        stage, staging = F.ring_staging(tm, core, 512, True, 3)
        assert stage == 64 * row
        # 256 resident columns: 512 bytes, odd units -> 528.
        assert staging == 3 * stage + 2 * tm * 528


@pytest.mark.parametrize("tm,dim,k,want", [
    (16, 256, 10, ("bf16x3w", 4, True)), (16, 768, 100, ("bf16x3w", 4, False)),
    (16, 256, 512, ("bf16x3", 3, False)), (16, 768, 1024, ("bf16x3", 4, True)),
    (32, 256, 10, ("bf16x3", 4, True)), (32, 768, 10, ("bf16x3", 4, False)),
    (32, 768, 256, ("bf16x3", 2, False)),
    (64, 256, 10, ("bf16x3w", 2, False)), (64, 768, 100, ("bf16x3", 2, False)),
    (64, 768, 128, ("bf16x3", 4, False)),
])
def test_plans_phase_1_prints(tm, dim, k, want):
    """The ring, stages and the query's place at chip_smoke.py's
    BF16X3_PLANS (tm 64 rides the query in every stage: 35,840 or 19,456
    bytes)."""
    stages, stage, resident, _ = F.stage_plan(tm, "bf16x3", 2 * dim, k)
    core = F.ring_core(tm, "bf16x3", 2 * dim, k)
    assert (core, stages, resident) == want
    if tm == 64:
        assert stage == {"bf16x3": 19456, "bf16x3w": 35840}[core]


@pytest.mark.parametrize("tm", (16, 32, 64))
def test_tile_64_consumer_rule(tm):
    """``wgmma_core``: the stored cores take the warpgroup consumer at
    query tile 64 and mma.sync below; bf16x3 and highest never (a
    warpgroup walk of bf16x3 was the slower at every shape measured,
    PERF.md).  bf16x3's plan is the mma.sync ring's at every tile and k,
    the stored cores' the warpgroup ring's at tile 64."""
    for core in F.CORES:
        assert F.wgmma_core(tm, core) == (
            tm == 64 and core in ("bf16c", "int8c", "int4c"))
    for k in (1, 10, 100, TOP_K[tm]):
        assert F.stage_plan(tm, "bf16x3", 512, k) == F.ring_plan(
            tm, F.ring_core(tm, "bf16x3", 512, k), 512, F.tail_bytes(tm, k))
        for core in ("bf16c", "int8c", "int4c"):
            c_ld = F._corpus_width(core, 256)
            assert (F.stage_plan(tm, core, c_ld, k) == F.wg_plan(core, k)) \
                == (tm == 64), (core, k)


# ---------------------------------------------------------------------------
# Models of the ring's k order.
# ---------------------------------------------------------------------------


def _stage_row(dim, kc, vec, core):
    """One corpus row as ring_corpus stages position kc of it: for each
    stage byte, the (half, feature, byte of the feature) it holds, or None
    where it is zero (0 hi, 1 lo).  vec: whole 16-byte copies (dim % 8 ==
    0), else byte by byte; both address the source the same way."""
    rb = F.ring_row_bytes(16, core)
    row_bytes, b0 = 4 * dim, kc * rb
    half, kh = row_bytes // 2, rb // 2
    out = [None] * rb
    pieces = range(0, rb, 16) if vec else range(rb)
    for o in pieces:
        width = 16 if vec else 1
        fo = b0 // 2 + o % kh
        if fo >= half:
            continue
        src = (0 if o < kh else half) + fo
        for b in range(width):
            s = src + b
            out[o + b] = (s // half, (s % half) // 2, s % 2)
    return out


def _query_feature(kc, col, core):
    """ring_feature for bf16x3: column col of chunk kc."""
    return kc * F.ring_cols(16, core) + col


@pytest.mark.parametrize("core", HILO)
@pytest.mark.parametrize("dim", DIMS + (5, 36, 100))
def test_mma_ring_slots_are_the_per_tile_cores(dim, core):
    """For every position and k16 step, each thread's B words (ch and cl at
    bytes 32 s + 4 tig and + 16 of the hi and lo pieces) and A words
    (query columns 16 s + 2 tig and + 8) hold the features of slots (2 tig,
    2 tig + 1) and (2 tig + 8, 2 tig + 9) of the step, hi and lo of the
    same feature; and the walk's k16 steps meet the features in the per-tile
    core's order (scores_bf16x3: chunks of 32, steps of 16), padding zero."""
    rb = F.ring_row_bytes(16, core)
    chunks = -(-4 * dim // rb)
    vec = dim % 8 == 0
    order = []
    for kc in range(chunks):
        row = _stage_row(dim, kc, vec, core)
        for s in range(rb // 64):
            slots = [None] * 16
            for tig in range(4):
                for part, (first, _) in enumerate(((2 * tig, 0),
                                                   (2 * tig + 8, 16))):
                    for e in range(2):
                        j = first + e
                        off = 32 * s + 4 * tig + 16 * part + 2 * e
                        hi = row[off:off + 2]
                        lo = row[rb // 2 + off:rb // 2 + off + 2]
                        feature = _query_feature(kc, 16 * s + j, core)
                        if feature >= dim:   # zero in all three
                            assert hi == [None, None] == lo
                        else:
                            assert hi == [(0, feature, 0), (0, feature, 1)]
                            assert lo == [(1, feature, 0), (1, feature, 1)]
                        slots[j] = feature
            order.append(slots)
    per_tile = [[k0 + ks + j for j in range(16)]
                for k0 in range(0, dim, 32) for ks in (0, 16)]
    # The 64-feature ring pads to a whole 64: two more zero steps at most.
    assert order[:len(per_tile)] == per_tile
    assert all(min(step) >= dim for step in order[len(per_tile):])
    assert len(order) - len(per_tile) in ((0,) if core == "bf16x3"
                                          else (0, 2))


def test_mma_ring_loads_hit_distinct_banks():
    """The fragments of a warp (each 8 x 8 matrix of an ldmatrix: 8 rows of
    16 bytes): 8 rows at 4 words each fall on 32 distinct banks, corpus
    rows at 144 or 272 bytes, query rows at an odd number of 16-byte units
    (riding: 80 or 144 bytes; resident at any dim)."""
    strides = [F.ring_staging(16, core, 512, True, 2)[0] // F._TN
               for core in HILO] + [80, 144]
    for stride in strides + [F._odd_units(64 * -(-d // 32), 16)
                             for d in DIMS]:
        assert stride % 16 == 0 and (stride // 16) % 2 == 1
        banks = {(g * stride // 4 + tig) % 32 for g in range(8)
                 for tig in range(4)}
        assert len(banks) == 32


# ---------------------------------------------------------------------------
# The port's bf16x3 path against the JAX package.
# ---------------------------------------------------------------------------


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _data(m, n, dim, seed, mean=0.0):
    r = np.random.default_rng(seed)
    return ((r.standard_normal((m, dim)) + mean).astype(np.float32),
            (r.standard_normal((n, dim)) + mean).astype(np.float32))


# The ring's edge dims; n a multiple of no tile; query tiles 16, 32, 64
# (m 9, 20, 65); k up to 512 (tile 16).
DENSE = [
    (9, 333, 1, 1, "cosine", False),
    (20, 700, 3, 10, "dot", True),
    (65, 333, 8, 100, "euclidean", False),
    (9, 1300, 255, 512, "dot", False),
    (37, 700, 256, 10, "cosine", True),
    (20, 333, 257, 256, "cosine", False),
    (65, 500, 768, 128, "dot", False),
]


@pytest.mark.parametrize("m,n,dim,k,metric,masked", DENSE)
def test_bf16x3_matches_jax(m, n, dim, k, metric, masked):
    q, c = _data(m, n, dim, seed=dim + k)
    mask = (np.arange(n) % 3 != 1) if masked else None
    before = dict(F.core_launches)
    pv, pi = F.fused_topk(_t(q), _t(c), k, metric,
                          mask=None if mask is None else _t(mask),
                          config=SearchConfig())
    assert F.core_launches == before   # the CPU runs the plain version
    jv, ji = JF.fused_topk(jnp.asarray(q), jnp.asarray(c), k, metric,
                           mask=None if mask is None else jnp.asarray(mask),
                           config=JConfig(block_n=256, precision="bf16x3"))
    assert_topk_equivalent(pi.numpy(), pv.numpy(), np.asarray(ji),
                           np.asarray(jv))


# (m, n, dim, k, metric, mean of the data): lists of three layout tiles a
# query block, the ragged last layout tile on every list.  The two sides
# sum a score's f32 products in their own orders, which may differ by
# about eps * sum_d |q_d c_d|: some 3e-5 for dot on 768 centred normals
# (sum about 490), above atol 8e-6 where a score is near zero (1.2e-5
# seen).  So dim 768 takes cosine on centred data, whose terms are 768
# times smaller, and dot on data of mean 1, whose scores (about 768) sit
# far from zero, where rtol governs.
LISTED = [(20, 1000, 3, 10, "dot", 0.0), (70, 1300, 257, 100, "dot", 0.0),
          (20, 1100, 768, 512, "cosine", 0.0),
          (20, 1100, 768, 100, "dot", 1.0),
          (40, 900, 1, 1, "euclidean", 0.0)]


@pytest.mark.parametrize("m,n,dim,k,metric,mean", LISTED)
def test_listed_bf16x3_matches_jax(m, n, dim, k, metric, mean):
    q, c = _data(m, n, dim, seed=n + k, mean=mean)
    jcfg = JConfig(block_n=256, precision="bf16x3")
    tn = JF.corpus_tile_rows(dim, jcfg, k)
    tm = JF.query_tile_rows(m, dim, jcfg, k)
    jcp, jcbp = JF.prepare_corpus(jnp.asarray(c), metric, tn=tn,
                                  precision="bf16x3")
    cp, cbp = F.prepared_from_jax(np.asarray(jcp).view(np.uint16),
                                  np.asarray(jcbp), n, dim)
    n_layout = -(-n // tn)
    r = np.random.default_rng(k)
    tiles = np.stack([np.sort(np.append(
        r.choice(n_layout - 1, 2, replace=False), n_layout - 1))
        for _ in range(-(-m // tm))]).astype(np.int32)
    jv, ji = JF.fused_topk_prepared(jnp.asarray(q), jcp, jcbp, k, metric,
                                    tn=tn, config=jcfg, interpret=True,
                                    tiles=jnp.asarray(tiles))
    pv, pi = F.fused_topk_prepared(_t(q), cp, cbp, k, metric,
                                   config=SearchConfig(block_n=256),
                                   precision="bf16x3", tiles=tiles, tn=tn)
    assert_topk_equivalent(pi.numpy(), pv.numpy(), np.asarray(ji),
                           np.asarray(jv))


@pytest.mark.parametrize("m,n,dim,k", [(37, 1000, 257, 10), (8, 700, 5, 100)])
def test_topk_entry_matches_jax_at_the_default_precision(m, n, dim, k):
    """The slice as a whole: ``topk`` from NumPy at the default precision
    (bf16x3) on the CPU against the JAX package's ``topk``."""
    assert SearchConfig().precision == "bf16x3"
    q, c = _data(m, n, dim, seed=m)
    idx, scores = topk(q, c, k, "cosine", device="cpu")
    jidx, jscores = JAPI.topk(q, c, k, "cosine",
                              config=JConfig(block_n=256))
    assert_topk_equivalent(np.asarray(idx), np.asarray(scores),
                           np.asarray(jidx), np.asarray(jscores))
