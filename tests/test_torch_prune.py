"""Kernel A's carry gate (``SearchConfig.prune``) in the PyTorch port,
against the JAX package's tile pruning on the same NumPy inputs.

The gate is exact in both packages: ``prune`` "on", "off" and "auto" give
the results of the gate off.  Here the port runs on ``device="cpu"``,
where kernel A's wrapper runs its plain version (no gate; the CUDA
kernel's gate is held bit for bit to the gate off by ``chip_smoke.py``
phase 2), and the JAX package runs its Pallas kernel in interpret mode
with the same ``prune``.  One JAX call a case: each case pairs a k with
one prune setting, and the port answers in all three settings.  Scores
agree within rtol 1e-4 / atol 5e-4 (the JAX package's clustered tests),
index differences only on tied scores.  Also held: how each setting
reaches kernel A through ``Corpus.topk``, ``ClusteredCorpus.topk``,
``topk_buffers`` and the sharded ``select_prepared`` (``prune_gate``:
"auto" is off on the card), the wrapper's counter argument, and autotune
measuring a gated launch as its own.
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
from polars_matmul_tpu_torch.api.arrow_ops import topk_buffers
from polars_matmul_tpu_torch.interop import buffers as B
from polars_matmul_tpu_torch.kernels import fused_topk as F
from polars_matmul_tpu_torch.utils import autotune as A

from conftest import assert_topk_equivalent

JF = importlib.import_module("polars_matmul_tpu.kernels.fused_topk")

torch.set_num_threads(2)

CPU = "cpu"
PRUNES = ("on", "off", "auto")
TOL = dict(rtol=1e-4, atol=5e-4)
# block_n=128 over 2000 rows: 16 corpus tiles, where the JAX package's
# "auto" turns its gate on.
N, DIM, M = 2000, 32, 20


def _data(seed=0, n=N, m=M, dim=DIM):
    r = np.random.default_rng(seed)
    return (r.standard_normal((m, dim)).astype(np.float32),
            r.standard_normal((n, dim)).astype(np.float32))


def _cfgs(prune):
    return (JConfig(block_q=8, block_n=128, prune=prune),
            SearchConfig(block_q=8, block_n=128, prune=prune))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _port_all(fn):
    """The port's answer in every prune setting: the same bits each time."""
    outs = [fn(prune) for prune in PRUNES]
    for v, i in outs[1:]:
        assert torch.equal(i, outs[0][1])
        assert torch.equal(v.view(torch.int32), outs[0][0].view(torch.int32))
    return outs[0]


# Each k with one prune setting on the JAX side (every k and every setting
# appear); the port answers in all three.
CASES = [(1, "on"), (10, "off"), (16, "auto"), (17, "on"), (100, "auto")]


@pytest.mark.parametrize("k,prune", CASES)
def test_dense_matches_jax(k, prune):
    q, c = _data(k)
    jcfg, _ = _cfgs(prune)
    jv, ji = JF.fused_topk(jnp.asarray(q), jnp.asarray(c), k, "cosine",
                           config=jcfg)
    pv, pi = _port_all(lambda p: pt.topk_torch(
        _t(q), _t(c), k, "cosine", config=_cfgs(p)[1]))
    assert_topk_equivalent(pi.numpy(), pv.numpy(), np.asarray(ji),
                           np.asarray(jv), **TOL)


@pytest.mark.parametrize("k,prune", [(17, "auto")])
def test_masked_matches_jax(k, prune):
    q, c = _data(20 + k)
    keep = np.random.default_rng(k).random(N) < 0.4
    jcfg, _ = _cfgs(prune)
    jv, ji = JF.fused_topk(jnp.asarray(q), jnp.asarray(c), k, "dot",
                           config=jcfg, mask=jnp.asarray(keep))
    pv, pi = _port_all(lambda p: pt.topk_torch(
        _t(q), _t(c), k, "dot", config=_cfgs(p)[1], mask=_t(keep)))
    assert_topk_equivalent(pi.numpy(), pv.numpy(), np.asarray(ji),
                           np.asarray(jv), **TOL)
    assert keep[pi.numpy()[pi.numpy() < N]].all()


@pytest.mark.parametrize("k,prune", [(1, "auto"), (100, "on")])
def test_probed_matches_jax(k, prune):
    """Kernel A on tile lists (the JAX kernel's PrefetchScalarGridSpec
    call), on the JAX package's prepared operands."""
    q, c = _data(40 + k)
    jcfg, _ = _cfgs(prune)
    tn = JF.corpus_tile_rows(DIM, jcfg, k)
    tm = JF.query_tile_rows(M, DIM, jcfg, k)
    jcp, jcbp = JF.prepare_corpus(jnp.asarray(c), "cosine", tn=tn,
                                  precision="bf16x3")
    cp, cbp = F.prepared_from_jax(np.asarray(jcp), np.asarray(jcbp), N, DIM)
    n_layout = -(-N // tn)
    r = np.random.default_rng(k)
    tiles = np.stack([np.sort(r.choice(n_layout, 12, replace=False))
                      for _ in range(-(-M // tm))]).astype(np.int32)
    jv, ji = JF.fused_topk_prepared(jnp.asarray(q), jcp, jcbp, k, "cosine",
                                    tn=tn, config=jcfg, interpret=True,
                                    tiles=jnp.asarray(tiles))
    pv, pi = _port_all(lambda p: F.fused_topk_prepared(
        _t(q), cp, cbp, k, "cosine", config=_cfgs(p)[1],
        precision="bf16x3", tiles=tiles, tn=tn))
    assert_topk_equivalent(pi.numpy(), pv.numpy(), np.asarray(ji),
                           np.asarray(jv), **TOL)


@pytest.mark.parametrize("k,prune", [(10, "on")])
def test_capacity_matches_jax(k, prune):
    """A corpus with capacity rows (dead by their bias) and a deletion,
    one add, one update."""
    q, c = _data(60 + k)
    jcfg, pcfg = _cfgs(prune)
    j = pmt.Corpus(c[:1500], capacity=N, config=jcfg)
    h = pt.Corpus(c[:1500], capacity=N, config=pcfg, device=CPU)
    for handle in (j, h):
        handle.add(c[1500:1800])
        handle.update([3, 700], c[1800:1802])
        handle.delete([5, 1600])
    ji, jv = j.topk(q, k)
    outs = []
    for p in PRUNES:
        h.config = _cfgs(p)[1]
        outs.append(h.topk(q, k))
    for idx, scores in outs:
        np.testing.assert_array_equal(idx, outs[0][0])
        np.testing.assert_array_equal(scores, outs[0][1])
    pi, pv = outs[0]
    assert_topk_equivalent(pi.astype(np.int64), pv, ji.astype(np.int64), jv,
                           **TOL)
    assert not np.isin(pi, [5, 1600]).any()


# ---------------------------------------------------------------------------
# How prune reaches kernel A.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prune,want", [("on", True), ("off", False),
                                         ("auto", False)])
def test_prune_gate(prune, want):
    """Only "on" turns the gate on: "auto" is off on the card."""
    assert F.prune_gate(prune) is want


def _spy(monkeypatch):
    """Record the ``prune`` each fused_select call receives."""
    seen = []
    orig = F.fused_select

    def spy(*args, prune=False, **kw):
        seen.append(prune)
        return orig(*args, prune=prune, **kw)

    monkeypatch.setattr(F, "fused_select", spy)
    return seen


@pytest.mark.parametrize("prune", PRUNES)
def test_handles_pass_prune_down(monkeypatch, prune):
    """Corpus.topk, ClusteredCorpus.topk (probed and exhaustive),
    topk_buffers and a sharded Corpus give kernel A the gate prune_gate
    says, whatever their corpus tiles."""
    seen = _spy(monkeypatch)
    q, c = _data(7)
    mesh = pt.make_mesh(1, 2, devices=[CPU, CPU])
    cfg = _cfgs(prune)[1]
    on = prune == "on"
    cc = pt.ClusteredCorpus(c, clusters=20, config=cfg, device=CPU)
    calls = (
        # 16 corpus tiles of 128 rows, where the JAX rule turns "auto" on
        (lambda: pt.Corpus(c, config=cfg, device=CPU).topk(q, 10), [on]),
        (lambda: cc.topk(q, 10), [on]),                   # >= 20 tiles
        (lambda: cc.topk(q, 10, probe=4), [on]),          # 4 listed
        (lambda: topk_buffers(B.matrix_column(q), pt.Corpus(
            c, config=cfg, device=CPU), 10), [on]),
        # two shards of 8 tiles
        (lambda: pt.Corpus(c, config=cfg, mesh=mesh).topk(q, 10),
         [on] * 2),
        # 5 corpus tiles
        (lambda: pt.topk(q, c[:600], 5, config=cfg, device=CPU), [on]),
    )
    for call, want in calls:
        del seen[:]
        call()
        assert seen == want, (prune, seen, want)


def test_gate_count_is_checked():
    q, c = _data(9, n=300)
    qp = F.prepare_queries(_t(q), "cosine", "bf16x3")
    cp, cbp = F.prepare_corpus(_t(c), "cosine", precision="bf16x3")
    args = (qp, cp, cbp, None, 5, "bf16x3", 1, 5, 16)
    for bad in (torch.zeros(2, dtype=torch.int64), torch.zeros(3,
                                                               dtype=torch.int32)):
        with pytest.raises(ValueError, match="gate_count"):
            F.fused_topk_partial(*args, prune=True, gate_count=bad)
    # On the CPU the plain version runs: the counter stays as it was.
    count = torch.zeros(2, dtype=torch.int32)
    on = F.fused_topk_partial(*args, prune=True, gate_count=count)
    off = F.fused_topk_partial(*args)
    assert torch.equal(on[0], off[0]) and torch.equal(on[1], off[1])
    assert count.tolist() == [0, 0]


def test_autotune_measures_the_gate_as_its_own_launch(monkeypatch):
    q, c = (_t(x) for x in _data(10, n=N))
    keys = []

    def timer(step, qq, **kw):
        step(qq)
        return {("fused", "bf16x3"): 2.0,
                ("fused", "gated", "bf16x3"): 1.0}[keys[-1]]

    orig = A._launch_key

    def key(cfg, qq, cc, kk):
        keys.append(orig(cfg, qq, cc, kk))
        return keys[-1]

    monkeypatch.setattr(A, "_launch_key", key)
    monkeypatch.setattr(A, "device_step_seconds", timer)
    base = SearchConfig(block_q=8, block_n=128, auto_tile=False)
    best = A._sweep([dict(), dict(prune="off"), dict(prune="on")], base, q,
                    c, 10, "cosine", False)
    plain, gated = ("fused", "bf16x3"), ("fused", "gated", "bf16x3")
    assert keys == [plain, plain, gated]
    assert best.prune == "on"
