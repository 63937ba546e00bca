"""utils.autotune of the PyTorch port against the JAX package.

The JAX package's autotune tests (tests/test_api.py:304-407) on the port,
the sweep grid and regime buckets equal to the JAX package's, the winners'
file read by either package, and the port's sweep: one measurement for
each distinct launch, ties kept by grid order.  The sweep runs here on
CPU tensors (the kernels' plain versions) with the timer replaced:
``autotune`` itself measures only on a card.
"""

import importlib
import json

import numpy as np
import pytest
import torch

import polars_matmul_tpu as pmt
import polars_matmul_tpu_torch as pt
from polars_matmul_tpu.utils import autotune as JA
from polars_matmul_tpu_torch.kernels import fused_topk as F
from polars_matmul_tpu_torch.utils import autotune as A

torch.set_num_threads(2)


def _data(m, n, dim, seed=5):
    r = np.random.default_rng(seed)
    return (torch.from_numpy(r.standard_normal((m, dim)).astype(np.float32)),
            torch.from_numpy(r.standard_normal((n, dim)).astype(np.float32)))


@pytest.fixture
def fresh_cache(tmp_path, monkeypatch):
    """Both packages' winner caches empty, their file under tmp_path."""
    monkeypatch.setenv("PMM_TPU_CACHE_DIR", str(tmp_path))
    for mod in (A, JA):
        monkeypatch.setattr(mod, "_WINNER_CACHE", {})
        monkeypatch.setattr(mod, "_DISK_LOADED", [False])
    return tmp_path


def test_autotune_on_the_cpu_returns_the_base_config_unmeasured():
    base = pt.SearchConfig(block_q=8, block_n=128)
    cfg = pt.autotune(m=8, n=64, dim=16, k=3, base=base,
                      candidates=[(16, 128, "highest")], device="cpu")
    assert cfg is base
    t = A.device_step_seconds(lambda q: q.max(dim=1, keepdim=True).values,
                              torch.ones((8, 16)), chain_lo=2, chain_hi=6,
                              iters=2)
    assert isinstance(t, float) and t > 0


def test_autotune_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.autotune(m=8, n=64, dim=16, k=3)


def test_autotune_cpu_set_default_installs_the_base(monkeypatch):
    monkeypatch.setattr(pt.config, "_default_config", pt.SearchConfig())
    base = pt.SearchConfig(prune="off")
    assert pt.autotune(base=base, set_default=True, device="cpu") is base
    assert pt.default_config() is base


def test_autotune_winner_persistence(fresh_cache, monkeypatch):
    key = ("fake-h100", 256, "small", "1seg", "cosine", "bf16x3")
    winner = pt.SearchConfig(block_q=128, block_n=1024, auto_tile=False)
    monkeypatch.setattr(A, "_WINNER_CACHE", {key: winner})
    A._save_disk_cache()

    monkeypatch.setattr(A, "_WINNER_CACHE", {})
    monkeypatch.setattr(A, "_DISK_LOADED", [False])
    A._load_disk_cache()
    got = A._WINNER_CACHE[key]
    assert (got.block_q, got.block_n, got.auto_tile) == (128, 1024, False)

    (fresh_cache / "autotune.json").write_text("{not json")
    monkeypatch.setattr(A, "_WINNER_CACHE", {})
    monkeypatch.setattr(A, "_DISK_LOADED", [False])
    A._load_disk_cache()
    assert A._WINNER_CACHE == {}


def test_cache_path_defaults_under_home(monkeypatch, tmp_path):
    monkeypatch.delenv("PMM_TPU_CACHE_DIR", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert A._cache_path() == str(
        tmp_path / ".cache" / "polars_matmul_tpu_torch" / "autotune.json")


def test_autotune_n_in_key_and_gstack_rewrite():
    assert A._n_regime(10_000) != A._n_regime(2_000_000)
    for sel, want in (("gstack", "auto"), ("gpop", "auto"),
                      ("bucket", "bucket"), ("extract", "extract")):
        cfg = pt.SearchConfig(selection=sel, block_q=128)
        got = A._finalize_winner(cfg)
        jgot = JA._finalize_winner(pmt.SearchConfig(selection=sel,
                                                    block_q=128))
        assert got.selection == jgot.selection == want
        assert got.block_q == 128


@pytest.mark.parametrize("k", [1, 10, 16, 17, 100, 128, 129, 1024])
def test_regimes_and_candidates_match_jax(k):
    assert A._k_regime(k) == JA._k_regime(k)
    for prec in ("bf16x3", "highest", "int8c"):
        assert (A.default_candidates(pt.SearchConfig(precision=prec), k)
                == JA.default_candidates(pmt.SearchConfig(precision=prec),
                                         k))


@pytest.mark.parametrize("n", [1, 10_000, 16_384, 16_385, 1_048_576,
                               1_048_577, 10_000_000])
def test_n_regime_matches_jax(n):
    assert A._n_regime(n) == JA._n_regime(n)


def test_cfg_fields_match_jax():
    assert A._CFG_FIELDS == JA._CFG_FIELDS == F._TUNED_FIELDS


WINNERS = {
    ("NVIDIA H100 80GB HBM3", 256, "small", "1seg", "cosine", "bf16x3"):
        dict(block_q=128, block_n=1024, auto_tile=False, precision="highest"),
    ("TPU v5 lite", 768, "large", "big", "dot", "int8c"):
        dict(block_q=128, block_n=4096, auto_tile=False, prune="off"),
    ("cpu", 32, "xl", "mid", "euclidean", "bf16x3"):
        dict(selection="extract", k_pad=256),
}


@pytest.mark.parametrize("writer,reader", [(A, JA), (JA, A)])
def test_winners_file_is_read_by_the_other_package(fresh_cache, writer,
                                                   reader):
    config = pt.SearchConfig if writer is A else pmt.SearchConfig
    for key, overrides in WINNERS.items():
        writer._WINNER_CACHE[key] = config(**overrides)
    writer._save_disk_cache()
    saved = json.loads((fresh_cache / "autotune.json").read_text())
    assert saved == {json.dumps(list(k)): v for k, v in WINNERS.items()}
    reader._load_disk_cache()
    for key, overrides in WINNERS.items():
        got = reader._WINNER_CACHE[key]
        for f in A._CFG_FIELDS:
            want = overrides.get(f, getattr(pt.SearchConfig(), f))
            assert getattr(got, f) == want


def test_dispatch_consults_cached_winner(monkeypatch):
    """An all-defaults fused_topk adopts the persisted winner for this
    device kind and problem class; pinned fields or use_autotune_cache=
    False keep their own, and results stay oracle-exact."""
    q, c = _data(8, 256, 32)
    key = ("cpu", 32, "small", "1seg", "cosine", "bf16x3")
    winner = pt.SearchConfig(selection="extract", prune="off",
                             precision="highest")
    monkeypatch.setattr(A, "_WINNER_CACHE", {key: winner})
    monkeypatch.setattr(A, "_DISK_LOADED", [True])   # never touch disk

    seen = {}
    orig = F.fused_topk_prepared

    def spy(*args, **kw):
        seen.update(kw)
        return orig(*args, **kw)

    monkeypatch.setattr(F, "fused_topk_prepared", spy)

    vals, idx = pt.topk_torch(q, c, 5, "cosine")
    cfg = seen["config"]
    assert (cfg.selection, cfg.prune, cfg.precision) == ("extract", "off",
                                                         "highest")
    assert seen["precision"] == "highest"
    qs = q.double() / q.double().norm(dim=1, keepdim=True)
    cs = c.double() / c.double().norm(dim=1, keepdim=True)
    ref = torch.sort(-(qs @ cs.T), dim=1, stable=True).indices[:, :5]
    assert torch.equal(idx.long(), ref)

    seen.clear()
    pt.topk_torch(q, c, 5, "cosine",
                  config=pt.SearchConfig(selection="bucket"))
    assert seen["config"].selection == "bucket"   # pinned: cache ignored
    assert seen["precision"] == "bf16x3"

    seen.clear()
    pt.topk_torch(q, c, 5, "cosine",
                  config=pt.SearchConfig(use_autotune_cache=False))
    assert seen["config"].selection == "auto"

    seen.clear()
    pt.topk_torch(q, c[:200], 5, "dot")   # another problem class
    assert seen["config"].selection == "auto"


def test_prepared_paths_do_not_consult_the_cache(monkeypatch):
    """As in the JAX package, only fused_topk adopts winners."""
    q, c = _data(8, 256, 32)
    key = ("cpu", 32, "small", "1seg", "cosine", "bf16x3")
    monkeypatch.setattr(A, "_WINNER_CACHE",
                        {key: pt.SearchConfig(precision="highest")})
    monkeypatch.setattr(A, "_DISK_LOADED", [True])
    seen = []
    orig = F.fused_select
    monkeypatch.setattr(F, "fused_select",
                        lambda *a, **kw: (seen.append(a[5]), orig(*a, **kw))[1])
    pt.Corpus(c).topk(q.numpy(), 5)
    assert seen == ["bf16x3"]


def test_cached_winner_is_keyed_by_device_kind(monkeypatch):
    key = ("cpu", 32, "large", "mid", "dot", "highest")
    win = pt.SearchConfig(block_q=128)
    monkeypatch.setattr(A, "_WINNER_CACHE", {key: win})
    monkeypatch.setattr(A, "_DISK_LOADED", [True])
    assert A.cached_winner(32, 100, 20_000, "dot", "highest",
                           device="cpu") is win
    assert A.cached_winner(32, 10, 20_000, "dot", "highest",
                           device="cpu") is None
    assert A._device_kind("cpu") == "cpu"


class _Timer:
    """A stand-in for device_step_seconds: fixed seconds per launch key,
    and the launches it was asked to time."""

    def __init__(self, seconds):
        self.seconds, self.timed = seconds, []

    def __call__(self, step, q, **kw):
        step(q)
        core = self.core
        self.timed.append(core)
        return self.seconds[core]


def _sweep(monkeypatch, seconds, k=5, candidates=None):
    q, c = _data(8, 300, 32)
    timer = _Timer(seconds)
    orig = A._launch_key

    def key(cfg, qq, cc, kk):
        out = orig(cfg, qq, cc, kk)
        timer.core = out[-1]
        return out

    monkeypatch.setattr(A, "_launch_key", key)
    monkeypatch.setattr(A, "device_step_seconds", timer)
    base = pt.SearchConfig()
    best = A._sweep(candidates or A.default_candidates(base, k), base, q, c,
                    k, "cosine", False)
    return best, timer.timed


def test_sweep_measures_each_distinct_launch_once(monkeypatch):
    """At 8 queries and k=5 the grid's selection="bucket" candidate takes
    kernel A's bucket selection and its "gstack" and "gpop" candidates its
    gstack selection: two launches of their own, each timed once."""
    best, timed = _sweep(monkeypatch, {"bf16x3": 2.0, "highest": 1.0})
    assert sorted(timed) == ["bf16x3", "bf16x3", "bf16x3", "highest"]
    assert best == pt.SearchConfig(block_q=256, block_n=2048,
                                   precision="highest", auto_tile=False)


def test_sweep_ties_keep_the_first_candidate(monkeypatch):
    best, timed = _sweep(monkeypatch, {"bf16x3": 1.0, "highest": 1.0})
    # bf16x3, its bucket and its gstack selections, highest
    assert len(timed) == 4
    assert best == pt.SearchConfig(block_q=128, block_n=1024,
                                   auto_tile=False)


def test_sweep_skips_candidates_outside_their_envelope(monkeypatch):
    """At k=20 gpop raises; its candidate is skipped, the rest run."""
    best, timed = _sweep(monkeypatch, {"bf16x3": 1.0, "highest": 3.0}, k=20,
                         candidates=[dict(selection="gpop"),
                                     dict(selection="extract"),
                                     dict(precision="highest")])
    assert timed == ["bf16x3", "highest"]
    assert best.selection == "extract"


def test_sweep_returns_the_base_when_nothing_runs(monkeypatch):
    best, timed = _sweep(monkeypatch, {}, k=20,
                         candidates=[dict(selection="gpop"),
                                     dict(selection="nope")])
    assert timed == [] and best == pt.SearchConfig()


def test_launch_key():
    q, c = _data(8, 300, 32)
    assert A._launch_key(pt.SearchConfig(selection="extract", block_q=8),
                         q, c, 5) == ("fused", "bf16x3")
    assert A._launch_key(pt.SearchConfig(precision="high"), q, c,
                         5) == ("fused", "highest")
    assert A._launch_key(pt.SearchConfig(use_pallas=False), q, c,
                         5) == ("reference",)
    assert A._launch_key(pt.SearchConfig(), q.double(), c.double(),
                         5) == ("reference",)


@pytest.mark.parametrize("m, k, precision, prune, want", [
    (8, 5, "bf16x3", "auto", ("fused", "bucket", "bf16x3")),
    (8, 16, "highest", "on", ("fused", "gated", "bucket", "highest")),
    (32, 1, "int8c", "off", ("fused", "bucket", "int8c")),
    (8, 17, "bf16x3", "auto", ("fused", "bf16x3")),      # k > 16: appends
    (100, 5, "bf16x3", "auto", ("fused", "bf16x3")),     # query tile 64
    (100, 5, "int8c", "auto", ("fused", "int8c")),       # warpgroup
])
def test_launch_key_bucket(m, k, precision, prune, want):
    """selection="bucket" is a launch of its own where kernel A builds the
    bucket selection (k <= 16 at query tiles 16 and 32), the insertion's
    launch elsewhere; "insert" and "auto" keep the insertion's (the slack's
    above k = 16, where "auto" takes the stack selection in its class)."""
    q, c = _data(m, 300, 32)
    cfg = pt.SearchConfig(selection="bucket", precision=precision,
                          prune=prune)
    assert A._launch_key(cfg, q, c, k) == want
    plain = tuple(x for x in want if x != "bucket")
    for sel in ("insert", "auto", "extract"):
        stack = ("stack",) if sel == "auto" and 17 <= k <= 32 else ()
        assert A._launch_key(cfg.with_updates(selection=sel), q, c,
                             k) == plain[:-1] + stack + plain[-1:]


@pytest.mark.parametrize("m, k, precision, prune, want", [
    (8, 5, "bf16x3", "auto", ("fused", "gstack", "bf16x3")),
    (8, 100, "highest", "on", ("fused", "gated", "gstack", "highest")),
    (100, 5, "bf16x3", "off", ("fused", "gstack", "bf16x3")),    # tile 64
    (100, 10, "bf16x3", "auto", ("fused", "bf16x3")),    # tile 64: no room
    (100, 10, "int8c", "auto", ("fused", "int8c")),       # warpgroup
    (8, 200, "bf16x3", "auto", ("fused", "bf16x3")),      # k > 128
])
def test_launch_key_gstack(m, k, precision, prune, want):
    """selection="gstack" and "gpop" are one launch of their own where
    kernel A builds the gstack selection (k <= 128 on the mma.sync ring
    and the f32 walk where its stacks fit), the own selection's launch
    elsewhere; "auto" and the others keep the own selection's; a winning
    "gstack" or "gpop" is persisted as "auto"."""
    q, c = _data(m, 300, 32)
    cfg = pt.SearchConfig(selection="gstack", precision=precision,
                          prune=prune)
    assert A._launch_key(cfg, q, c, k) == want
    assert A._launch_key(cfg.with_updates(selection="gpop"), q, c,
                         k) == want
    plain = tuple(x for x in want if x != "gstack")
    for sel in ("insert", "auto", "extract"):
        assert A._launch_key(cfg.with_updates(selection=sel), q, c,
                             k) == plain
    assert A._finalize_winner(cfg).selection == "auto"


def test_autotune_is_exported():
    assert pt.autotune is A.autotune
    assert importlib.import_module(
        "polars_matmul_tpu_torch.utils.autotune") is A
