"""The quantized cores of the PyTorch port's kernel A ("bf16c", "int8c",
"int4c") and their quantizers, against the JAX package.

On the CPU the port's wrappers run the plain versions of the CUDA kernels;
the JAX side runs its Pallas kernel in interpret mode with 256-row corpus
tiles, as the JAX package's own tests do.  The same NumPy inputs go to
both.  Codes, packed bytes and dequant scales must be bit-identical, the
scale | bias rows agree within a few ulps, and scores within
``assert_topk_equivalent``'s defaults.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polars_matmul_tpu.api import search as jsearch
from polars_matmul_tpu.config import SearchConfig as JConfig
from polars_matmul_tpu_torch import SearchConfig
from polars_matmul_tpu_torch.kernels import storage as pstorage
from polars_matmul_tpu_torch.kernels import fused_topk as F

from conftest import assert_topk_equivalent

JF = importlib.import_module("polars_matmul_tpu.kernels.fused_topk")

torch.set_num_threads(2)

METRICS = ["cosine", "dot", "euclidean"]
QUANT = ["bf16c", "int8c", "int4c"]


def _data(m, n, dim, seed=31):
    r = np.random.default_rng(seed)
    c = r.standard_normal((n, dim)).astype(np.float32)
    c[[3, n // 2]] = 0.0   # zero rows: scale 1.0, zero norm
    return r.standard_normal((m, dim)).astype(np.float32), c


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _port(q, c, k, metric, mask=None, **cfg):
    v, i = F.fused_topk(_t(q), _t(c), k, metric,
                        mask=None if mask is None else _t(mask),
                        config=SearchConfig(**cfg))
    return i.numpy(), v.numpy()


def _jax(q, c, k, metric, mask=None, **cfg):
    v, i = JF.fused_topk(jnp.asarray(q), jnp.asarray(c), k, metric,
                         mask=None if mask is None else jnp.asarray(mask),
                         config=JConfig(block_n=256, **cfg))
    return np.asarray(i), np.asarray(v)


@pytest.mark.parametrize("dim", [56, 300])
def test_quantize_int8_bit_identical_to_jax(dim):
    _, c = _data(1, 90, dim)
    codes, scales = F.quantize_int8(_t(c))
    jc, js = JF.quantize_int8(jnp.asarray(c))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(js))
    assert scales[3] == 1.0 and (codes[3] == 0).all()
    hc, hs = pstorage._quantize_rows_np(c)
    np.testing.assert_array_equal(hc, codes.numpy())
    np.testing.assert_array_equal(hs, scales.numpy())
    # The JAX package's host quantizer (f64 input takes its NumPy branch).
    jhc, jhs = jsearch._quantize_rows_np(c.astype(np.float64))
    np.testing.assert_array_equal(hc, jhc)
    np.testing.assert_array_equal(hs, jhs)


# 4200 > 4096 takes the chunk-interleaved layout (2048-wide chunks).
@pytest.mark.parametrize("dim", [56, 300, 4200])
def test_quantize_int4_bit_identical_to_jax(dim):
    _, c = _data(1, 40, dim, seed=32)
    ck, dpp, _ = F.feature_geometry(dim)
    assert (ck, dpp) == JF.feature_geometry(dim)[:2]
    packed, scales = F.quantize_int4(_t(c), ck)
    jp, js = JF.quantize_int4(jnp.asarray(c), ck)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(js))
    hp, hs = pstorage._quantize_rows_int4_np(c, ck, dpp)
    np.testing.assert_array_equal(hp, packed.numpy())
    np.testing.assert_array_equal(hs, scales.numpy())
    jhp, jhs = jsearch._quantize_rows_int4_np(c.astype(np.float64), ck, dpp)
    np.testing.assert_array_equal(hp, jhp)
    np.testing.assert_array_equal(hs, jhs)
    codes = F.unpack_int4(packed, dim).numpy()
    np.testing.assert_array_equal(codes, jsearch._unpack_int4_np(hp, ck, dim))
    np.testing.assert_array_equal(codes, pstorage._unpack_int4_np(hp, ck, dim))
    assert codes.min() >= -7 and codes.max() <= 7
    np.testing.assert_array_equal(
        F.dequant_int4(packed, scales, dim).numpy(),
        np.asarray(JF.dequant_int4(jp, js, dim)))


def test_nibble_unpack_covers_every_byte():
    # Every byte value, -8 included (the quantizer never writes it, a
    # pre-packed corpus may): the int8 unpack equals the i32-widened one.
    b = np.arange(-128, 128, dtype=np.int8).reshape(1, 256)
    lo, hi = F._unpack_nibbles(_t(b))
    jlo, jhi = JF._unpack_int4_i32(jnp.asarray(b.astype(np.int32)))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))


@pytest.mark.parametrize("storage", ["int8", "int4"])
@pytest.mark.parametrize("metric", METRICS)
def test_scale_bias_rows_match_jax(metric, storage):
    _, c = _data(1, 70, 300, seed=33)
    n_valid = 66   # the last rows stand for padding: bias -inf
    if storage == "int8":
        codes, scales = F.quantize_int8(_t(c))
        got = F.prepare_int8_bias(codes, scales, metric, n_valid)
        want = JF.prepare_int8_bias(jnp.asarray(codes.numpy()),
                                    jnp.asarray(scales.numpy()), metric,
                                    n_valid)
    else:
        codes, scales = F.quantize_int4(_t(c), F.feature_geometry(300)[0])
        got = F.prepare_int4_bias(codes, scales, metric, n_valid)
        want = JF.prepare_int4_bias(jnp.asarray(codes.numpy()),
                                    jnp.asarray(scales.numpy()), metric,
                                    n_valid)
    assert got.shape == (2, 70)
    assert np.isneginf(got[1, n_valid:].numpy()).all()
    assert np.isfinite(got[0].numpy()).all()
    # The code norms are exact (sums of integer squares), but XLA rewrites
    # 1 / sqrt(x) as rsqrt(x) and reassociates -(scale * norm)^2; the two
    # differ from the correctly rounded results by a few ulps at most
    # (4e-7 relative).
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=4e-7,
                               atol=0)
    if metric == "dot":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# n = 333 is a multiple of no tile height; k = 129 raises the JAX carry.
@pytest.mark.parametrize("k", [1, 10, 129])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("precision", QUANT)
def test_plain_cores_match_jax(precision, metric, k):
    q, c = _data(9, 333, 56)
    mask = np.arange(333) % 5 != 2
    assert_topk_equivalent(*_port(q, c, k, metric, mask, precision=precision),
                           *_jax(q, c, k, metric, mask, precision=precision))


@pytest.mark.parametrize("precision", QUANT)
def test_plain_cores_match_jax_dim300(precision):
    q, c = _data(7, 333, 300, seed=34)
    assert_topk_equivalent(*_port(q, c, 20, "dot", precision=precision),
                           *_jax(q, c, 20, "dot", precision=precision))


def _tie_data(m, n, dim, seed=5):
    """Rows of four +-1 entries, every row twinned: every score of a row
    is one of a few exact values, in any summation order."""
    r = np.random.default_rng(seed)
    c = np.zeros((n, dim), np.float32)
    for row in c:
        row[r.choice(dim, 4, replace=False)] = r.choice([-1.0, 1.0], 4)
    c[n // 2:] = c[: n - n // 2]
    return c[r.choice(n, m)].copy(), c


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("precision", QUANT)
def test_tie_order_matches_jax_extract(precision, metric):
    q, c = _tie_data(6, 300, 48)
    pi, pv = _port(q, c, 129, metric, precision=precision)
    ji, jv = _jax(q, c, 129, metric, precision=precision,
                  selection="extract")
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(pv, jv, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("precision", QUANT)
def test_prepared_from_jax_gives_same_topk(precision, metric):
    q, c = _data(8, 301, 300, seed=35)
    jcp, jcbp = JF.prepare_corpus(jnp.asarray(c), metric, tn=128,
                                  precision=precision)
    cp, cbp = F.prepared_from_jax(np.asarray(jcp), np.asarray(jcbp),
                                  n=301, dim=300)
    own_cp, own_cbp = F.prepare_corpus(_t(c), metric, precision=precision)
    assert cp.dtype == own_cp.dtype and cp.shape == own_cp.shape
    assert cbp.shape == own_cbp.shape
    if precision != "bf16c":
        # The same codes; scale | bias within a few ulps (see above).
        assert torch.equal(cp, own_cp)
        np.testing.assert_allclose(cbp.numpy(), own_cbp.numpy(),
                                   rtol=4e-7, atol=0)
    got = F.fused_topk_prepared(_t(q), cp, cbp, 20, metric,
                                precision=precision)
    want = F.fused_topk(_t(q), _t(c), 20, metric,
                        config=SearchConfig(precision=precision))
    assert_topk_equivalent(got[1].numpy(), got[0].numpy(),
                           want[1].numpy(), want[0].numpy())


def test_int4_above_dim_4096_matches_jax():
    q, c = _data(3, 40, 4200, seed=36)
    assert_topk_equivalent(*_port(q, c, 5, "cosine", precision="int4c"),
                           *_jax(q, c, 5, "cosine", precision="int4c"))


@pytest.mark.parametrize("precision", QUANT)
def test_split_and_merge_equal_the_plain_version(precision, monkeypatch):
    # Plain kernel A (chunked over a few splits at a time) merged by plain
    # kernel B gives exactly the plain version's result.
    monkeypatch.setattr(F, "_PLAIN_CHUNK", 4096)
    q, c = _tie_data(5, 700, 32, seed=7)
    mask = F.pad_mask_row(_t(np.arange(700) % 3 != 0), 700)
    qp = F.prepare_queries(_t(q), "euclidean", precision)
    cp, cbp = F.prepare_corpus(_t(c), "euclidean", precision=precision)
    tm, splits, tps = F.launch_geometry(5, 700, 10, sm_count=132)
    assert splits > 1
    pv, pi = F.fused_topk_partial(qp, cp, cbp, mask, 10, precision, splits,
                                  tps, tm)
    v, i = F.topk_merge(pv, pi, 10)
    want_v, want_i = F.fused_topk_plain(qp, cp, cbp, mask, 10, precision)
    assert torch.equal(v, want_v) and torch.equal(i, want_i)


def test_quantized_operands_are_checked():
    q, c = _data(4, 100, 16)
    qp = F.prepare_queries(_t(q), "dot", "int8c")
    cp, cbp = F.prepare_corpus(_t(c), "dot", precision="int8c")
    assert cbp.shape == (2, 100)
    with pytest.raises(ValueError, match="cbp"):
        F.fused_select(qp, cp, cbp[1].contiguous(), None, 5, "int8c")
    with pytest.raises(ValueError, match="shapes"):
        F.fused_select(qp, cp, cbp, None, 5, "int4c")   # packed width 64
    with pytest.raises(TypeError):
        F.fused_select(qp, cp, cbp, None, 5, "bf16c")
    with pytest.raises(ValueError, match="prepared as"):
        F.fused_topk_prepared(_t(q), cp, cbp, 5, "dot", precision="bf16c")
    with pytest.raises(ValueError, match="scales"):
        F.prepare_corpus(cp, "dot", precision="int8c")
    with pytest.raises(RuntimeError, match="no kernel"):
        F.fused_select(qp.to("meta"), cp.to("meta"), cbp.to("meta"), None,
                       5, "int8c")
    assert F.kernel_precision("default") == "highest"
    for p in QUANT:
        assert F.kernel_precision(p) == p
