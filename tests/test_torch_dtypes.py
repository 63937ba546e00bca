"""Mixed operand dtypes: ``matmul_torch`` / ``topk_torch`` against the JAX
package's ``matmul_jax`` / ``topk_jax`` on the same values, in each of six
(query, corpus) mixes.

The JAX package's rule: the product takes the queries' dtype
(``preferred_element_type=q.dtype``); f32 queries take the fused path
whatever the corpus's float width; other queries take the reference path,
whose scores follow JAX's promotion (bf16 / f16 queries give f32 cosine and
euclidean scores and half-precision dot scores).  Each result must have
the JAX package's dtype, and values within the tolerance of the queries'
dtype: f32 ``assert_topk_equivalent``'s (rtol 2e-5, atol 8e-6) and rtol /
atol 1e-5 for the product; f64 queries on an f32 corpus 1e-6 (the
corpus's norms are f32 sums); f16 queries 2^-9 and bf16 ones 2^-6, a few
roundings of their precision (both packages round the product and the
query norms to it, in other orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polars_matmul_tpu.kernels.fused_topk import fused_topk as topk_jax
from polars_matmul_tpu.kernels.matmul import pairwise_matmul as matmul_jax
import polars_matmul_tpu_torch as pt

from conftest import assert_topk_equivalent

torch.set_num_threads(2)

DTYPES = {"f32": (jnp.float32, torch.float32),
          "f64": (jnp.float64, torch.float64),
          "bf16": (jnp.bfloat16, torch.bfloat16),
          "f16": (jnp.float16, torch.float16)}
MIXES = [("f32", "f64"), ("f64", "f32"), ("bf16", "f32"), ("f32", "bf16"),
         ("f16", "f32"), ("f32", "f16")]
# rtol = atol by the queries' dtype (see the module docstring).
TOL = {"f32": None, "f64": 1e-6, "f16": 2.0 ** -9, "bf16": 2.0 ** -6}


def _operands(qd, cd):
    rng = np.random.default_rng(0)
    q = rng.standard_normal((5, 16))
    c = rng.standard_normal((40, 16))
    qj = jnp.asarray(q).astype(DTYPES[qd][0])
    cj = jnp.asarray(c).astype(DTYPES[cd][0])
    # The same values in torch: through float64, exact for every dtype.
    qt = torch.from_numpy(np.array(qj.astype(jnp.float64))).to(DTYPES[qd][1])
    ct = torch.from_numpy(np.array(cj.astype(jnp.float64))).to(DTYPES[cd][1])
    return qj, cj, qt, ct


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


@pytest.mark.parametrize("op", ["matmul", "cosine", "dot", "euclidean"])
@pytest.mark.parametrize("mix", MIXES, ids=["/".join(m) for m in MIXES])
def test_mixed_dtypes_match_jax(mix, op):
    qd, cd = mix
    qj, cj, qt, ct = _operands(qd, cd)
    tol = TOL[qd]
    if op == "matmul":
        want = matmul_jax(qj, cj)
        got = pt.matmul_torch(qt, ct)
        assert _dtype_name(got.dtype) == str(want.dtype)
        np.testing.assert_allclose(
            got.double().numpy(), np.asarray(want.astype(jnp.float64)),
            rtol=tol or 1e-5, atol=tol or 1e-5)
        return
    wv, wi = topk_jax(qj, cj, 3, op)
    gv, gi = pt.topk_torch(qt, ct, 3, op)
    assert _dtype_name(gv.dtype) == str(wv.dtype)
    assert gi.dtype == torch.int32
    kw = {} if tol is None else {"rtol": tol, "atol": tol}
    assert_topk_equivalent(gi.numpy().astype(np.int64),
                           gv.double().numpy(),
                           np.asarray(wi).astype(np.int64),
                           np.asarray(wv.astype(jnp.float64)), **kw)
