"""The selection envelopes of the PyTorch port against the JAX package.

An explicit ``selection`` of "gpop", "gstack", "bucket", "stack" or
"insert" outside the envelope the JAX kernel gives it raises the JAX
package's ValueError (``_resolve_selection``); the port, whose kernels A +
B serve every value alike, raises the same error on the same geometry.
The JAX side is stopped right after it resolves the selection (its kernel
never runs), the port's right before its kernels (or plain versions) run.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import polars_matmul_tpu as pmt
import polars_matmul_tpu_torch as pt
from polars_matmul_tpu.config import SearchConfig as JConfig
from polars_matmul_tpu_torch import SearchConfig
from polars_matmul_tpu_torch.kernels import fused_topk as F

JF = importlib.import_module("polars_matmul_tpu.kernels.fused_topk")

torch.set_num_threads(2)

CPU = "cpu"


class _Resolved(Exception):
    """Raised where the selection was resolved without an error."""


@pytest.fixture
def stop_after_resolution(monkeypatch):
    """Stop the JAX package right after ``_resolve_selection`` returns and
    the port right before ``fused_select``: what raises, raises first."""
    orig = JF._resolve_selection

    def resolved(*args, **kw):
        orig(*args, **kw)
        raise _Resolved

    def reached(*args, **kw):
        raise _Resolved

    monkeypatch.setattr(JF, "_resolve_selection", resolved)
    monkeypatch.setattr(F, "fused_select", reached)


def _outcome(fn):
    """The ValueError message ``fn`` raises, or "resolved"."""
    try:
        fn()
    except _Resolved:
        return "resolved"
    except ValueError as e:
        return str(e)
    raise AssertionError("neither resolved nor raised")


def _data(m, n, dim, seed=34):
    r = np.random.default_rng(seed)
    return (r.standard_normal((m, dim)).astype(np.float32),
            r.standard_normal((n, dim)).astype(np.float32))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# tests/test_kernels.py:247-263 and :347-362, on the port.
# ---------------------------------------------------------------------------


def test_gstack_envelope_errors():
    """gstack on a segmented corpus whose tile's group count does not
    divide 128 raises; beyond the fused ceiling the resolution refuses."""
    q, c = _data(4, 20_000, 16)
    cfg = SearchConfig(selection="gstack", block_q=8, block_n=384)
    with pytest.raises(ValueError, match="gstack") as got:
        F.fused_topk(_t(q), _t(c), 20, "dot", config=cfg)
    with pytest.raises(ValueError) as want:
        JF.fused_topk(q, c, 20, "dot", config=JConfig(
            selection="gstack", block_q=8, block_n=384), interpret=True)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="gstack"):
        F.check_selection("gstack", 1100, 200, False, 7)


def test_gpop_envelope_errors():
    """gpop with k > 16, over more than 128 groups, or k >= k_pad raises."""
    rng = np.random.default_rng(39)
    q = rng.standard_normal((4, 16)).astype(np.float32)
    c_small = rng.standard_normal((500, 16)).astype(np.float32)
    c_big = rng.standard_normal((20_000, 16)).astype(np.float32)
    cases = [(c_small, 20, {}), (c_big, 10, {}), (c_small, 16,
                                                   {"k_pad": 16})]
    for c, k, extra in cases:
        with pytest.raises(ValueError, match="gpop") as got:
            F.fused_topk(_t(q), _t(c), k, "dot", config=SearchConfig(
                selection="gpop", block_q=8, block_n=128, **extra))
        with pytest.raises(ValueError) as want:
            JF.fused_topk(q, c, k, "dot", config=JConfig(
                selection="gpop", block_q=8, block_n=128, **extra),
                interpret=True)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# check_selection against _resolve_selection, argument for argument.
# ---------------------------------------------------------------------------

SELECTIONS = ["auto", "extract", "bucket", "stack", "insert", "gstack",
              "gpop"]
# (k, total_groups, use_tiles, n_tiles, k_pad, gpt)
GEOMETRIES = [
    (10, 80, False, 5, 128, 16),
    (16, 80, False, 5, 16, 16),
    (20, 80, False, 5, 128, 16),
    (10, 160, False, 10, 128, 16),
    (20, 159, False, 53, 128, 3),
    (129, 80, False, 5, 256, 16),
    (300, 2000, False, 125, 384, 16),
    (1024, 80, False, 5, 1024, 16),
    (1100, 200, False, 7, 1152, 16),
    (5, 160, True, 4, 128, 16),
    (20, 160, True, 50, 128, 3),
    (200, 1000, True, 10, 256, 8),
]


@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("selection", SELECTIONS)
def test_check_selection_raises_as_resolve_selection(selection, geometry):
    def jax():
        JF._resolve_selection(selection, *geometry)
        raise _Resolved

    def port():
        F.check_selection(selection, *geometry)
        raise _Resolved

    assert _outcome(port) == _outcome(jax)


# ---------------------------------------------------------------------------
# End to end: the geometry each package builds from a call.
# ---------------------------------------------------------------------------

# (selection, k, rows, config overrides)
DENSE = [
    ("gpop", 5, 500, {}),
    ("gpop", 5, 20_000, {}),
    ("gpop", 16, 500, {}),
    ("gpop", 10, 500, {"k_pad": 10}),
    ("gpop", 20, 500, {}),
    ("gstack", 20, 20_000, {"block_q": 8, "block_n": 384}),
    ("gstack", 20, 5000, {"block_q": 8, "block_n": 384}),
    ("gstack", 20, 20_000, {}),
    ("gstack", 200, 20_000, {}),
    ("gstack", 200, 20_000, {"block_n": 640}),
    ("bucket", 129, 500, {}),
    ("stack", 200, 500, {}),
    ("insert", 129, 500, {"k_pad": 256}),
    ("insert", 128, 500, {}),
    ("extract", 300, 500, {}),
    ("auto", 20, 20_000, {"block_n": 384}),
]


@pytest.mark.parametrize("selection,k,rows,extra", DENSE)
def test_dense_calls_raise_as_jax(stop_after_resolution, selection, k, rows,
                                  extra):
    q, c = _data(4, rows, 16)

    def jax():
        JF.fused_topk(q, c, k, "dot", config=JConfig(selection=selection,
                                                     **extra),
                      interpret=True)

    def port():
        F.fused_topk(_t(q), _t(c), k, "dot",
                     config=SearchConfig(selection=selection, **extra))

    assert _outcome(port) == _outcome(jax)


# (selection, k, rows, tiles listed, config overrides)
PROBED = [
    ("gpop", 5, 20_000, 2, {}),
    ("gstack", 20, 20_000, 3, {}),
    ("gstack", 20, 20_000, 50, {"block_q": 8, "block_n": 384}),
    ("gstack", 20, 20_000, 40, {"block_q": 8, "block_n": 384}),
    ("gstack", 200, 20_000, 5, {}),
    ("bucket", 129, 20_000, 2, {}),
    ("stack", 16, 20_000, 2, {}),
    ("extract", 129, 20_000, 2, {}),
]


@pytest.mark.parametrize("selection,k,rows,p,extra", PROBED)
def test_probed_calls_raise_as_jax(stop_after_resolution, selection, k, rows,
                                   p, extra):
    """fused_topk_prepared with tile lists (probed search)."""
    m, dim = 8, 16
    q, c = _data(m, rows, dim)
    jcfg = JConfig(selection=selection, **extra)
    cfg = SearchConfig(selection=selection, **extra)
    tn = JF.corpus_tile_rows(dim, jcfg, k)
    assert tn == F.layout_tile_rows(dim, cfg, k)
    blocks = -(-m // F.probe_block_rows(m, dim, cfg, k))
    tiles = np.tile(np.arange(p, dtype=np.int32), (blocks, 1))

    def jax():
        cp, cbp = JF.prepare_corpus(jnp.asarray(c), JF.Metric.DOT, tn=tn,
                                    precision=jcfg.precision)
        JF.fused_topk_prepared(jnp.asarray(q), cp, cbp, k, "dot", tn=tn,
                               config=jcfg, interpret=True,
                               tiles=jnp.asarray(tiles))

    def port():
        cp, cbp = F.prepare_corpus(_t(c), "dot", precision=cfg.precision)
        F.fused_topk_prepared(_t(q), cp, cbp, k, "dot", config=cfg,
                              tiles=_t(tiles), tn=tn)

    assert _outcome(port) == _outcome(jax)


# ---------------------------------------------------------------------------
# The public handles, and what still runs.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("selection,k,rows", [("gpop", 20, 500),
                                              ("gpop", 5, 20_000),
                                              ("bucket", 200, 500)])
def test_corpus_topk_raises_as_jax(selection, k, rows):
    q, c = _data(4, rows, 16)
    with pytest.raises(ValueError) as want:
        pmt.Corpus(c, config=JConfig(selection=selection)).topk(q, k)
    with pytest.raises(ValueError) as got:
        pt.Corpus(c, config=SearchConfig(selection=selection),
                  device=CPU).topk(q, k)
    assert str(got.value) == str(want.value)


def test_clustered_probed_gpop_raises_as_jax():
    q, c = _data(8, 20_000, 16)
    cc = pt.ClusteredCorpus(c, config=SearchConfig(selection="gpop"),
                            device=CPU)
    with pytest.raises(ValueError, match=r"\(probed\)") as got:
        cc.topk(q, 5, probe=0.5)
    p = -(-cc.n_tiles // 2)
    geometry = (5, cc.n_tiles * cc.layout.tn // 128, True, p, 128,
                cc.layout.tn // 128)
    with pytest.raises(ValueError) as want:
        JF._resolve_selection("gpop", *geometry)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("selection,k,extra", [
    ("gpop", 5, {}), ("gstack", 20, {}), ("bucket", 10, {}),
    ("stack", 20, {}), ("insert", 128, {}), ("extract", 300, {}),
])
def test_in_envelope_selections_return_what_auto_returns(selection, k,
                                                         extra):
    """Inside its envelope every selection runs kernels A + B (here their
    plain versions) exactly as "auto" does: bit for bit."""
    q, c = _data(5, 900, 24)
    want = F.fused_topk(_t(q), _t(c), k, "cosine", config=SearchConfig())
    got = F.fused_topk(_t(q), _t(c), k, "cosine",
                       config=SearchConfig(selection=selection, **extra))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---------------------------------------------------------------------------
# The big-k envelope is computed once per geometry.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("geometry", [(512, 2000, False, 125, 512, 16),
                                      (300, 2000, False, 125, 384, 16),
                                      (200, 1000, True, 10, 256, 8)])
def test_gstack_envelope_is_memoized(geometry):
    """A repeated explicit gstack at k > 128 reads its envelope from the
    caches: the hits grow and no new entry is computed, and the answer is
    still ``_resolve_selection``'s."""
    funcs = (F._bigk_tail, F._bigk_depth, F._bigk_gstack_ok)

    def port():
        F.check_selection("gstack", *geometry)
        raise _Resolved

    def jax():
        JF._resolve_selection("gstack", *geometry)
        raise _Resolved

    first = _outcome(port)
    before = [f.cache_info() for f in funcs]
    for _ in range(3):
        assert _outcome(port) == first
    after = [f.cache_info() for f in funcs]
    assert after[2].hits >= before[2].hits + 3
    assert [a.misses for a in after] == [b.misses for b in before]
    assert first == _outcome(jax)
