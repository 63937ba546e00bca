"""kernels.matmul of the PyTorch port against the JAX package.

``pallas_matmul`` on CPU tensors runs kernel C's plain version
(``pallas_matmul_plain``); the JAX side runs its Pallas template in
interpret mode, as the JAX package's own tests do.  The same NumPy inputs
go to both.  Tolerances:

- "highest" (and "default", "high"): rtol = atol = 1e-5, the JAX package's
  own ``test_pallas_matmul``, with the relative part taken of the term
  scale |q_i| |c_j| where it exceeds |value|: two f32 sums of dim terms in
  another order differ by a few ulps of the terms, not of a result that
  cancels (chip_smoke.py compares kernel C with the same rule);
- "bf16x3" (and "bf16c") against JAX's exact f32 product: 2^-15 *
  sum_d |q_d c_d| + 1e-6 a value.  The split drops lo.lo and the bf16
  rounding of each lo, about 3 * 2^-18 of a term on average; the JAX
  function computes "bf16x3" in full f32.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import polars_matmul_tpu_torch as pt
import polars_matmul_tpu_torch.kernels as PK
from polars_matmul_tpu.kernels import matmul as JM
from polars_matmul_tpu_torch.kernels import matmul as M

torch.set_num_threads(2)

CPU = "cpu"
# (m, n, dim, blocks): the JAX package's tests (tests/test_kernels.py:
# 438-452: its shared 37 x 203 x 56 problem, and dim 300 over K tiles of
# 128), then ragged shapes that fill no block.
SHAPES = [
    (37, 203, 56, {}),
    (16, 40, 300, {"block_k": 128}),
    (1, 1, 1, {}),
    (1, 129, 3, {}),
    (9, 333, 56, {"block_m": 8, "block_n": 128}),
    (130, 257, 129, {}),
    (300, 129, 300, {"block_k": 128}),
    (65, 7, 520, {"block_m": 64, "block_k": 256}),
]
# Shapes wide enough for the bf16x3 bound (a few terms can each reach
# 3 * 2^-16 of their size; many terms average out).
WIDE = [s for s in SHAPES if s[2] >= 56]


def _data(m, n, dim, seed=3, dtype=np.float32):
    r = np.random.default_rng(seed + m + 7 * n + 13 * dim)
    return (r.standard_normal((m, dim)).astype(dtype),
            r.standard_normal((n, dim)).astype(dtype))


def _jax(q, c, **kw):
    return np.asarray(JM.pallas_matmul(jnp.asarray(q), jnp.asarray(c),
                                       interpret=True, **kw))


def _port(q, c, **kw):
    return M.pallas_matmul(q, c, device=CPU, **kw).numpy()


def _terms(q, c):
    """sum_d |q_d c_d| per output, in float64."""
    return np.abs(q.astype(np.float64)) @ np.abs(c.astype(np.float64)).T


@pytest.mark.parametrize("precision", ["highest", "default", "high"])
@pytest.mark.parametrize("m,n,dim,blocks", SHAPES)
def test_highest_matches_jax(m, n, dim, blocks, precision):
    q, c = _data(m, n, dim)
    got = _port(q, c, precision=precision, **blocks)
    want = _jax(q, c, precision=precision, **blocks)
    assert got.dtype == np.float32 and got.shape == (m, n)
    scale = (np.linalg.norm(q, axis=1)[:, None]
             * np.linalg.norm(c, axis=1)[None, :])
    tol = 1e-5 + 1e-5 * np.maximum(np.abs(want), scale)
    assert np.all(np.abs(got - want) <= tol)


@pytest.mark.parametrize("precision", ["bf16x3", "bf16c"])
@pytest.mark.parametrize("m,n,dim,blocks", WIDE)
def test_bf16x3_matches_jax_within_the_split_bound(m, n, dim, blocks,
                                                   precision):
    q, c = _data(m, n, dim)
    got = _port(q, c, precision=precision, **blocks)
    want = _jax(q, c, precision=precision, **blocks)
    tol = 2.0 ** -15 * _terms(q, c) + 1e-6
    assert np.all(np.abs(got.astype(np.float64) - want) <= tol)


def _split_np(x):
    """x = hi + lo in bf16 halves, from NumPy alone: hi rounds in IEEE bit
    space (+0x8000, clear the low 16 bits), lo = x - hi rounded to bf16."""
    bits = x.view(np.uint32)
    hi = ((bits + np.uint32(0x8000)) & np.uint32(0xFFFF0000)).view(
        np.float32)
    lo = (x - hi).astype(ml_dtypes.bfloat16).astype(np.float32)
    return hi.astype(np.float64), lo.astype(np.float64)


@pytest.mark.parametrize("m,n,dim,blocks", SHAPES[:6])
def test_bf16x3_plain_is_the_three_split_products(m, n, dim, blocks):
    """The plain version's bf16x3 is qh.ch + qh.cl + ql.ch of the split
    halves: within the f32 summation bound dim * 2^-24 * sum |terms|."""
    q, c = _data(m, n, dim)
    qh, ql = _split_np(q)
    ch, cl = _split_np(c)
    want = qh @ ch.T + (qh @ cl.T + ql @ ch.T)
    got = _port(q, c, precision="bf16x3", **blocks).astype(np.float64)
    tol = dim * 2.0 ** -24 * _terms(q, c) + 1e-7
    assert np.all(np.abs(got - want) <= tol)


def test_f64_round_trip():
    """f64 in, f64 out, computed in f32, in both packages."""
    q, c = _data(5, 7, 300, dtype=np.float64)
    got = M.pallas_matmul(q, c, device=CPU)
    want = _jax(q, c)
    assert got.dtype == torch.float64 and want.dtype == np.float64
    exact = q @ c.T
    scale = (np.linalg.norm(q, axis=1)[:, None]
             * np.linalg.norm(c, axis=1)[None, :])
    assert np.all(np.abs(got.numpy() - exact) <= 1e-6 * scale)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # computed in f32: not the f64 product itself
    assert not np.array_equal(got.numpy(), exact)


def test_torch_tensor_dtype_follows_q():
    q, c = _data(6, 9, 40, dtype=np.float64)
    got = M.pallas_matmul(torch.from_numpy(q), torch.from_numpy(c))
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    half = M.pallas_matmul(torch.from_numpy(q).half(), torch.from_numpy(c))
    assert half.dtype == torch.float16


@pytest.mark.parametrize("precision", ["int8c", "int4c", "nope", "HIGHEST"])
def test_unknown_precision_is_a_key_error_in_both(precision):
    q, c = _data(4, 5, 8)
    with pytest.raises(KeyError):
        _jax(q, c, precision=precision)
    with pytest.raises(KeyError):
        _port(q, c, precision=precision)


@pytest.mark.parametrize("qs,cs", [((0, 8), (5, 8)), ((4, 8), (0, 8)),
                                   ((4, 0), (5, 0))])
def test_empty_operands_raise_in_both(qs, cs):
    q, c = np.zeros(qs, np.float32), np.zeros(cs, np.float32)
    with pytest.raises(ZeroDivisionError):
        _jax(q, c)
    with pytest.raises(ValueError, match="non-empty"):
        _port(q, c)


@pytest.mark.parametrize("blocks", [{"block_m": 0}, {"block_n": -128},
                                    {"block_k": 1.5}])
def test_bad_block_sizes_raise(blocks):
    q, c = _data(4, 5, 8)
    with pytest.raises(ValueError, match="positive int"):
        _port(q, c, **blocks)


def test_block_sizes_do_not_change_the_result():
    q, c = _data(37, 203, 56)
    base = _port(q, c, precision="bf16x3")
    for blocks in ({"block_k": 128}, {"block_m": 8, "block_n": 128}):
        np.testing.assert_array_equal(
            _port(q, c, precision="bf16x3", **blocks), base)


def test_shape_mismatch_raises():
    with pytest.raises(ValueError, match=r"\(m, dim\) and \(n, dim\)"):
        _port(np.ones((3, 4), np.float32), np.ones((5, 6), np.float32))


def test_numpy_inputs_default_to_cuda_and_never_fall_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    q, c = _data(4, 5, 8)
    before = dict(M.launches)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.pallas_matmul(q, c)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.pallas_matmul(torch.from_numpy(q), c, device="cuda")
    assert M.launches == before


def test_cpu_tensors_run_the_plain_version_and_count_it():
    q, c = _data(4, 5, 8)
    M.reset_launch_counts()
    out = M.pallas_matmul(torch.from_numpy(q), torch.from_numpy(c),
                          precision="bf16c")
    assert out.device.type == "cpu"
    assert M.launches == {"pallas_matmul": 0, "pallas_matmul_plain": 1}
    assert M.core_launches == {"highest": 0, "bf16x3": 0}
    M.pallas_matmul(q, c, device=torch.device("cpu"))
    assert M.launches["pallas_matmul_plain"] == 2


def test_other_devices_raise():
    q, c = _data(4, 5, 8)
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        M.pallas_matmul(q, c, device="meta")


def test_plain_version_refuses_unknown_cores():
    q, c = (torch.from_numpy(x) for x in _data(4, 5, 8))
    with pytest.raises(ValueError, match="no kernel C core"):
        M.pallas_matmul_plain(q, c, "bf16c")


def test_exports_match_jax():
    from polars_matmul_tpu import kernels as JK

    assert PK.pallas_matmul is M.pallas_matmul
    assert JK.pallas_matmul is JM.pallas_matmul
    assert pt.matmul_torch is M.pairwise_matmul


# The bf16x3 core's split (kernel C's Hopper redesign): its plain version
# and padding.

@pytest.mark.parametrize("dim", [1, 56, 300, 4100])
def test_split_pad_plain_is_the_jax_split_padded(dim):
    """``split_pad_plain`` is the JAX package's ``_split_hi_lo`` of each
    operand bit for bit, each half zero-padded to whole 64-feature boxes,
    and hi + lo is x but for lo's rounding to bf16: x - hi is exact in
    f32 and at most half a bf16 ulp of x, so lo is within 2^-9 of it
    relatively, 2^-18 of |x| (bounded here by 2^-17)."""
    from polars_matmul_tpu.kernels.fused_topk import _split_hi_lo

    q, c = _data(5, 7, dim)
    dp = M.padded_dim(dim)
    got = M.split_pad_plain(torch.from_numpy(q), torch.from_numpy(c))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (12, 2 * dp)
    bits = got.view(torch.int16).numpy().view(np.uint16)
    halves = got.float().numpy()
    for rows, x in ((slice(0, 5), q), (slice(5, 12), c)):
        want = np.asarray(_split_hi_lo(jnp.asarray(x))).view(np.uint16)
        np.testing.assert_array_equal(bits[rows, :dim], want[:, :dim])
        np.testing.assert_array_equal(bits[rows, dp:dp + dim], want[:, dim:])
        assert not bits[rows, dim:dp].any()
        assert not bits[rows, dp + dim:].any()
        joined = halves[rows, :dim] + halves[rows, dp:dp + dim]
        assert np.all(np.abs(joined - x) <= 2.0 ** -17 * np.abs(x))


def test_split_pad_on_cpu_runs_and_counts_the_plain_version():
    q, c = (torch.from_numpy(x) for x in _data(3, 4, 70))
    M.reset_launch_counts()
    got = M.split_pad(q, c)
    assert M.split_launches == {"split_pad": 0, "split_pad_plain": 1}
    assert torch.equal(got.view(torch.int16),
                       M.split_pad_plain(q, c).view(torch.int16))
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        M.split_pad(q.to("meta"), c.to("meta"))


@pytest.mark.parametrize("dim,dp", [(1, 64), (56, 64), (64, 64), (65, 128),
                                    (300, 320), (768, 768), (4100, 4160)])
def test_padded_dim(dim, dp):
    assert M.padded_dim(dim) == dp


def test_ab_tool_imports_no_jax_and_needs_a_card():
    """``tools/ab_matmul.py`` (kernel C, parent against change on the
    card) imports nothing of JAX and refuses to run without a card."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    code = ("import sys; import polars_matmul_tpu_torch.tools.ab_matmul; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'polars_matmul_tpu' or "
            "m.startswith('polars_matmul_tpu.')]; assert not bad, bad")
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=str(root)))
    assert r.returncode == 0, r.stderr
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from polars_matmul_tpu_torch.tools import ab_matmul

    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        ab_matmul.main(root / "build" / "parent")
