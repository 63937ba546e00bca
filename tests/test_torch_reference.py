"""ops.reference of the PyTorch port against the JAX package's, on the
same NumPy inputs (CPU tensors on the port's side)."""

import numpy as np
import pytest
import torch

from polars_matmul_tpu.ops import reference as jref
from polars_matmul_tpu_torch.ops import reference as tref
from polars_matmul_tpu_torch.ops.metrics import Metric, cosine_eps

from conftest import assert_topk_equivalent

torch.set_num_threads(2)

METRICS = ["cosine", "dot", "euclidean"]
INT32_MAX = np.iinfo(np.int32).max
# f32: the two frameworks sum the products in another order.
F32_TOL = dict(rtol=1e-5, atol=1e-6)
# f64: the same, at f64 rounding; atol covers scores near zero.
F64_TOL = dict(rtol=1e-12, atol=1e-12)


def _data(dtype, m=13, n=211, dim=40, seed=7):
    # Unit-scale rows: atol then bounds the rounding of unit-scale sums.
    r = np.random.default_rng(seed)
    q = (r.standard_normal((m, dim)) / np.sqrt(dim)).astype(dtype)
    c = (r.standard_normal((n, dim)) / np.sqrt(dim)).astype(dtype)
    c[5] = 0.0   # a zero-norm row: cosine scores it 0.0
    return q, c


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dtype,tol", [(np.float32, F32_TOL),
                                       (np.float64, F64_TOL)])
def test_pairwise_scores_matches_jax(metric, dtype, tol):
    q, c = _data(dtype)
    want = np.asarray(jref.pairwise_scores(q, c, metric))
    got = tref.pairwise_scores(_t(q), _t(c), metric).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dtype,tol", [(np.float32, F32_TOL),
                                       (np.float64, F64_TOL)])
def test_topk_search_matches_jax(metric, dtype, tol):
    q, c = _data(dtype)
    jv, ji = jref.topk_search(q, c, 17, Metric.parse(metric).value)
    tv, ti = tref.topk_search(_t(q), _t(c), 17, metric)
    assert ti.dtype == torch.int32 and tv.dtype == _t(q).dtype
    assert_topk_equivalent(ti.numpy(), tv.numpy(), np.asarray(ji),
                           np.asarray(jv), **tol)


@pytest.mark.parametrize("metric", METRICS)
def test_mask_sentinels_match_jax(metric):
    q, c = _data(np.float32)
    mask = np.zeros(c.shape[0], bool)
    mask[[3, 50, 77, 150]] = True
    jv, ji = jref.topk_search(q, c, 9, metric, mask=mask)
    tv, ti = tref.topk_search(_t(q), _t(c), 9, metric, mask=_t(mask))
    worst = -np.inf if Metric.parse(metric).higher_is_better else np.inf
    assert (tv.numpy()[:, 4:] == worst).all()
    assert (ti.numpy()[:, 4:] == INT32_MAX).all()
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **F32_TOL)


@pytest.mark.parametrize("metric", METRICS)
def test_ties_go_to_lowest_index(metric):
    # Exactly representable data: rows of four +-1 entries (norm 2), so
    # every score is exact in any summation order and duplicates tie.
    r = np.random.default_rng(3)
    base = np.zeros((40, 24), np.float32)
    for row in base:
        row[r.choice(24, 4, replace=False)] = r.choice([-1.0, 1.0], 4)
    c = np.concatenate([base, base, base[::-1]])
    q = base[:6].copy()
    jv, ji = jref.topk_search(q, c, 25, metric)
    tv, ti = tref.topk_search(_t(q), _t(c), 25, metric)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # duplicates of the query row itself: lowest index first
    assert ti.numpy()[0, 0] == 0


def test_topk_from_scores_is_stable():
    s = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]])
    v, i = tref.topk_from_scores(s, 4, True)
    assert i.tolist() == [[1, 2, 4, 3]]
    v, i = tref.topk_from_scores(s, 3, False)
    assert i.tolist() == [[0, 3, 1]]


def test_exact_matmul_restores_tf32_flags():
    before = torch.backends.cuda.matmul.allow_tf32
    with tref.exact_matmul():
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 == before


def test_metric_parse_and_eps_match_jax():
    from polars_matmul_tpu.ops.metrics import Metric as JMetric
    from polars_matmul_tpu.ops.metrics import cosine_eps as jeps

    assert Metric.parse("L2") is Metric.EUCLIDEAN
    assert [m.value for m in Metric] == [m.value for m in JMetric]
    for m in Metric:
        assert m.higher_is_better == JMetric(m.value).higher_is_better
    with pytest.raises(ValueError) as got:
        Metric.parse("hamming")
    with pytest.raises(ValueError) as want:
        JMetric.parse("hamming")
    assert str(got.value) == str(want.value)
    assert cosine_eps(torch.float32) == jeps(np.float32)
    assert cosine_eps(np.float64) == jeps(np.float64)
