"""kernels.fused_topk of the PyTorch port against the JAX package.

On the CPU the port's wrappers run the plain versions of its CUDA kernels;
the JAX side runs its Pallas kernel in interpret mode, as the JAX package's
own tests do.  The same NumPy inputs go to both.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polars_matmul_tpu.config import SearchConfig as JConfig
from polars_matmul_tpu_torch import SearchConfig
from polars_matmul_tpu_torch.kernels import fused_topk as F

from conftest import assert_topk_equivalent

JF = importlib.import_module("polars_matmul_tpu.kernels.fused_topk")

torch.set_num_threads(2)

INT32_MAX = np.iinfo(np.int32).max
METRICS = ["cosine", "dot", "euclidean"]
PRECISIONS = ["bf16x3", "highest"]


def _data(m, n, dim, seed=11):
    r = np.random.default_rng(seed)
    return (r.standard_normal((m, dim)).astype(np.float32),
            r.standard_normal((n, dim)).astype(np.float32))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _port(q, c, k, metric, mask=None, **cfg):
    """(indices, scores), the argument order of assert_topk_equivalent."""
    v, i = F.fused_topk(_t(q), _t(c), k, metric,
                        mask=None if mask is None else _t(mask),
                        config=SearchConfig(**cfg))
    return i.numpy(), v.numpy()


def _jax(q, c, k, metric, mask=None, **cfg):
    """JAX with 256-row corpus tiles: several tiles per corpus (the carry
    crosses tiles) and a quicker interpret-mode run than 2048."""
    v, i = JF.fused_topk(jnp.asarray(q), jnp.asarray(c), k, metric,
                         mask=None if mask is None else jnp.asarray(mask),
                         config=JConfig(block_n=256, **cfg))
    return np.asarray(i), np.asarray(v)


def _tie_data(m, n, dim, seed=5):
    """Rows of four +-1 entries (norm 2): every score is exact in f32 in
    any summation order and in bf16 (lo = 0), with many exact ties."""
    r = np.random.default_rng(seed)
    c = np.zeros((n, dim), np.float32)
    for row in c:
        row[r.choice(dim, 4, replace=False)] = r.choice([-1.0, 1.0], 4)
    c[n // 2:] = c[: n - n // 2]
    return c[r.choice(n, m)].copy(), c


# n = 333 is a multiple of no tile height; k = 129 raises the carry width.
@pytest.mark.parametrize("k", [1, 10, 100, 129])
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("metric", METRICS)
def test_plain_matches_jax_auto_dim56(metric, precision, k):
    q, c = _data(9, 333, 56)
    assert_topk_equivalent(*_port(q, c, k, metric, precision=precision),
                           *_jax(q, c, k, metric, precision=precision))


@pytest.mark.parametrize("metric,precision,k", [
    ("cosine", "bf16x3", 10), ("dot", "bf16x3", 129),
    ("euclidean", "bf16x3", 100), ("cosine", "highest", 129),
])
def test_plain_matches_jax_auto_dim300(metric, precision, k):
    q, c = _data(7, 333, 300, seed=12)
    assert_topk_equivalent(*_port(q, c, k, metric, precision=precision),
                           *_jax(q, c, k, metric, precision=precision))


@pytest.mark.parametrize("k", [10, 129])
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("metric", METRICS)
def test_tie_order_matches_jax_extract(metric, precision, k):
    q, c = _tie_data(6, 300, 48)
    pi, pv = _port(q, c, k, metric, precision=precision)
    ji, jv = _jax(q, c, k, metric, precision=precision, selection="extract")
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(pv, jv, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("metric", METRICS)
def test_mask_sentinels_match_jax(metric):
    q, c = _data(5, 333, 56, seed=13)
    mask = np.zeros(333, bool)
    mask[[2, 40, 41, 300]] = True
    pi, pv = _port(q, c, 10, metric, mask)
    ji, jv = _jax(q, c, 10, metric, mask)
    worst = np.inf if metric == "euclidean" else -np.inf
    assert (pv[:, 4:] == worst).all() and (pi[:, 4:] == INT32_MAX).all()
    assert np.isin(pi[:, :4], [2, 40, 41, 300]).all()
    assert_topk_equivalent(pi, pv, ji, jv)


def test_split_hi_lo_bit_identical_to_jax():
    r = np.random.default_rng(0)
    x = (r.standard_normal((50, 300))
         * np.exp(r.uniform(-30, 30, (50, 300)))).astype(np.float32)
    # zeros, subnormals, and a value whose hi rounds up to inf (lo = -inf)
    x[0, :5] = [0.0, -0.0, 1e-40, -3e-39, 3.4e38]
    want = np.asarray(JF._split_hi_lo(jnp.asarray(x))).view(np.uint16)
    got = F.split_hi_lo(_t(x)).view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(got, want)


def _jax_prepared(c, metric, precision, tn=128):
    cp, cbp = JF.prepare_corpus(jnp.asarray(c), metric, tn=tn,
                                precision=precision)
    cp = np.asarray(cp)
    if precision == "bf16x3":
        cp = cp.view(np.uint16)
    return cp, np.asarray(cbp)


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("metric", METRICS)
def test_prepared_from_jax_gives_same_topk(metric, precision):
    q, c = _data(8, 301, 300, seed=14)
    cp, cbp = F.prepared_from_jax(*_jax_prepared(c, metric, precision),
                                  n=301, dim=300)
    cfg = SearchConfig(precision=precision)
    got = F.fused_topk_prepared(_t(q), cp, cbp, 20, metric, config=cfg)
    want = F.fused_topk(_t(q), _t(c), 20, metric, config=cfg)
    assert_topk_equivalent(got[1].numpy(), got[0].numpy(),
                           want[1].numpy(), want[0].numpy())


def test_prepared_from_jax_undoes_chunk_interleave():
    # dim > 4096: JAX lays hi|lo out as [hi_0|lo_0|hi_1|lo_1|...] in 2048
    # feature chunks.  dot has no prep scaling, so the port's own split of
    # the raw corpus must come back bit for bit.
    q, c = _data(3, 40, 4200, seed=15)
    cp, cbp = F.prepared_from_jax(*_jax_prepared(c, "dot", "bf16x3"),
                                  n=40, dim=4200)
    own_cp, own_cbp = F.prepare_corpus(_t(c), "dot", precision="bf16x3")
    assert torch.equal(cp.view(torch.int16), own_cp.view(torch.int16))
    assert torch.equal(cbp, own_cbp)
    got = F.fused_topk_prepared(_t(q), cp, cbp, 5, "dot")
    assert_topk_equivalent(got[1].numpy(), got[0].numpy(),
                           *_jax(q, c, 5, "dot"))


@pytest.mark.parametrize("k", [1, 10, 100])
def test_split_and_merge_equal_the_plain_version(k):
    # The kernels' plumbing on the CPU: per-split lists (plain kernel A)
    # merged (plain kernel B) give exactly the plain version's result.
    q, c = _tie_data(5, 700, 32, seed=k)
    mask = F.pad_mask_row(_t(np.arange(700) % 3 != 0), 700)
    qp = F.prepare_queries(_t(q), "dot", "bf16x3")
    cp, cbp = F.prepare_corpus(_t(c), "dot", precision="bf16x3")
    tm, splits, tps = F.launch_geometry(5, 700, k, sm_count=132)
    assert splits > 1 and splits * tps * 64 >= 700
    pv, pi = F.fused_topk_partial(qp, cp, cbp, mask, k, "bf16x3", splits,
                                  tps, tm)
    assert pv.shape == (5, splits, k)
    v, i = F.topk_merge(pv, pi, k)
    want_v, want_i = F.fused_topk_plain(qp, cp, cbp, mask, k, "bf16x3")
    assert torch.equal(v, want_v) and torch.equal(i, want_i)


def test_cpu_tensors_run_the_plain_version_and_count_it():
    q, c = _data(4, 100, 16)
    before = dict(F.launches)
    F.fused_topk(_t(q), _t(c), 5, "cosine")
    assert F.launches["fused_topk_plain"] == before["fused_topk_plain"] + 1
    assert F.launches["fused_topk_partial"] == before["fused_topk_partial"]
    assert F.launches["topk_merge"] == before["topk_merge"]


def test_reference_paths_skip_the_kernels():
    q, c = _data(4, 100, 16)
    before = F.launches["fused_topk_plain"]
    F.fused_topk(_t(q).double(), _t(c).double(), 5, "dot")     # f64
    F.fused_topk(_t(q), _t(c), 5, "dot",
                 config=SearchConfig(use_pallas=False))
    F.fused_topk(_t(q), _t(c), 100, "dot", config=SearchConfig())
    assert F.launches["fused_topk_plain"] == before + 1   # only the last
    with pytest.raises(ValueError, match="ceiling"):
        F.fused_topk_prepared(_t(q), *F.prepare_corpus(
            _t(c), "dot", precision="bf16x3"), 1025, "dot")


def test_k_pad_above_the_kernel_ceiling_runs_the_reference():
    # JAX serves k <= k_pad fused with a 2048-wide carry; the port's
    # kernels stop at 1024, so the same config takes the reference path
    # and must give the same top-k.
    q, c = _data(3, 1600, 16, seed=3)
    cfg = {"k_pad": 2048}
    assert F.max_fused_k(SearchConfig(**cfg)) == 1024
    assert not F.supports(q.shape, c.shape, np.float32, 1500,
                          SearchConfig(**cfg))
    before = F.launches["fused_topk_plain"]
    got = _port(q, c, 1500, "cosine", **cfg)
    assert F.launches["fused_topk_plain"] == before
    assert got[0].shape == (3, 1500)
    assert_topk_equivalent(*got, *_jax(q, c, 1500, "cosine", **cfg))


def test_wrappers_check_their_operands():
    q, c = _data(4, 100, 16)
    qp = F.prepare_queries(_t(q), "dot", "bf16x3")
    cp, cbp = F.prepare_corpus(_t(c), "dot", precision="bf16x3")
    with pytest.raises(TypeError):
        F.fused_select(qp.float(), cp, cbp, None, 5, "bf16x3")
    with pytest.raises(ValueError, match="contiguous"):
        F.fused_select(qp[:, ::2].repeat(1, 2)[:, ::1].T.contiguous().T,
                       cp, cbp, None, 5, "bf16x3")
    with pytest.raises(ValueError, match="cbp"):
        F.fused_select(qp, cp, cbp[:50], None, 5, "bf16x3")
    with pytest.raises(ValueError, match="mask"):
        F.fused_select(qp, cp, cbp, torch.ones(100, dtype=torch.bool), 5,
                       "bf16x3")
    with pytest.raises(RuntimeError, match="no kernel"):
        F.fused_select(qp.to("meta"), cp.to("meta"), cbp.to("meta"), None,
                       5, "bf16x3")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        F.prepare_corpus(_t(c).double(), "dot", precision="bf16x3")


def test_geometry_helpers_match_jax():
    for k in (1, 10, 128, 129, 512, 1024):
        cfg = SearchConfig(k_pad=128)
        assert F.effective_k_pad(k, cfg) == JF.effective_k_pad(k, JConfig())
        assert F.max_fused_k(cfg) == JF.max_fused_k(JConfig())
    for shape, k in [((5, 300), 10), ((5, 9000), 10), ((10**5, 9000), 10),
                     ((5, 300), 1025)]:
        assert (F.supports(shape, (10**5, shape[1]), np.float32, k,
                           SearchConfig())
                == JF.supports(shape, (10**5, shape[1]), np.float32, k,
                               JConfig()))
    assert not F.supports((5, 3), (9, 3), torch.float64, 1, SearchConfig())
    for dim in (3, 300, 4096, 4200, 9000):
        assert F.feature_geometry(dim) == JF.feature_geometry(dim)
