"""Kernel D's plain version (``kernels/floor.py``) against the JAX
package's three experiment kernels.

The JAX side builds each Pallas kernel of ``tools/`` with the BlockSpecs
of its ``measure*`` function and runs it in interpret mode; the port runs
``floor_stacks`` on CPU tensors (its plain version, at the geometry of a
notional 132-SM card, so several splits).  The same NumPy inputs go to
both:

- ``_kernel_ab`` (``exp_floor.py``): bf16x3, global ids, levels 0, 1, 4;
- ``_kernel_build`` (``exp_b256.py``): int8c, segmented ids, levels 0 and
  2, posu or not, within one segment and across several (one tile height
  that divides 16,384 rows and one that does not);
- ``_kernel_mm`` (``exp_int4.py``): one tile-local level in its four
  modes (int8, the int4 nibbles, the 16 hi + lo repack, the raw bytes).

Tolerances: level 0 decoded to f32 within 2^-15 relative + 1e-6 (the two
sides sum bf16 products in another order, and a packed value drops the
low 7 bits of its score, 2^-16 of it), group ids exact wherever the
cell's best two candidates differ by more than that; ``levels=0`` sums
exact, on integer data (every score exact in f32) and on queries of norm
1000 (no tile maximum of these seeds lies within rounding of an
integer).  Every split's
levels 0..L of the plain version equal, bit for bit, a NumPy sort of each
cell's packed values.
"""

import functools
import importlib
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from polars_matmul_tpu_torch.kernels import floor as D
from polars_matmul_tpu_torch.kernels import fused_topk as F
from polars_matmul_tpu_torch.tools import exp_int4 as PI

# The JAX package's kernels/__init__ shadows the module with its function.
JF = importlib.import_module("polars_matmul_tpu.kernels.fused_topk")

torch.set_num_threads(2)

TOOLS = Path(__file__).resolve().parents[1] / "tools"
M, DIM, TM = 16, 128, 8
CPU = torch.device("cpu")


@functools.lru_cache(maxsize=None)
def _tool(name):
    """The JAX package's ``tools/<name>.py``, imported by its path."""
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}",
                                                  TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bf16(bits: np.ndarray):
    """uint16 bf16 bits -> (jax array, torch tensor)."""
    j = jnp.asarray(bits.view(ml_dtypes.bfloat16))
    return j, torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)


def _split(x: np.ndarray):
    """f32 rows -> bf16 [hi | lo] as both packages split them."""
    bits = F.split_hi_lo(torch.from_numpy(x)).view(torch.int16).numpy()
    return _bf16(bits.view(np.uint16))


def _run_jax(kernel, q, c, cb, tn, scratch, **kw):
    """One ``tools/`` kernel in interpret mode, the BlockSpecs of its
    ``measure*`` function."""
    m, n = q.shape[0], c.shape[0]
    call = pl.pallas_call(
        functools.partial(kernel, tm=TM, tn=tn, **kw),
        grid=(m // TM, n // tn),
        in_specs=[
            pl.BlockSpec((TM, q.shape[1]), lambda i, j: (i, 0)),
            pl.BlockSpec((tn, c.shape[1]), lambda i, j: (j, 0)),
            pl.BlockSpec((cb.shape[0], tn), lambda i, j: (0, j)),
        ],
        out_specs=[pl.BlockSpec((TM, 128), lambda i, j: (i, 0))],
        out_shape=[jax.ShapeDtypeStruct((m, 128), jnp.int32)],
        scratch_shapes=[pltpu.VMEM((scratch, TM, 128), jnp.int32)],
        interpret=True,
    )
    with jax.enable_x64(False):
        (o,) = call(q, c, cb)
    return np.asarray(o)


def _np_pack(s: np.ndarray, tn: int, ids: str, posu: bool) -> np.ndarray:
    """NumPy packing of f32 scores: (u & ~127) | id(col); u alone for
    ``ids="none"``."""
    bits = s.astype(np.float32).view(np.int32)
    u = bits if posu else bits ^ ((bits >> 31) & np.int32(0x7FFFFFFF))
    col = np.arange(s.shape[1])
    if ids == "none":   # the order-preserving ints alone
        return u
    if ids == "global":
        gid = 127 - col // 128
    elif ids == "segmented":
        gid = 127 - (col % D.segment_rows(tn)) // 128
    else:
        gid = (col % tn) // 128
    return (u & np.int32(~127)) | gid.astype(np.int32)


def _np_cells(p: np.ndarray, lo: int, hi: int, levels: int) -> np.ndarray:
    """(m, levels, 128): each (row, lane) cell's largest packed values over
    columns [lo, hi), INT32_MIN where it has fewer."""
    m = p.shape[0]
    g0, g1 = lo // 128, -(-hi // 128)
    cells = np.full((m, (g1 - g0) * 128), D.INT32_MIN, np.int64)
    cells[:, lo - g0 * 128:hi - g0 * 128] = p[:, lo:hi]
    cells = -np.sort(-cells.reshape(m, g1 - g0, 128), axis=1)
    cells = np.concatenate(
        [cells, np.full((m, levels, 128), D.INT32_MIN, np.int64)], axis=1)
    return cells[:, :levels].astype(np.int32)


def _np_split_levels(p, n, tn, ids, levels, splits, tps):
    """(m, splits, levels, 128): every split's cells, each over the split's
    last segment when segmented."""
    rows, seg = tps * 64, D.segment_rows(tn)
    out = []
    for s in range(splits):
        lo, hi = s * rows, min(n, (s + 1) * rows)
        if ids == "segmented":
            lo = max(lo, (hi - 1) // seg * seg)
        out.append(_np_cells(p, lo, hi, levels))
    return np.stack(out, axis=1)


def _decoded(p: np.ndarray, posu: bool) -> np.ndarray:
    u = p & np.int32(~127)
    bits = u if posu else u ^ ((u >> 31) & np.int32(0x7FFFFFFF))
    return bits.view(np.float32).astype(np.float64)


def _data(kind, n, dim, seed):
    """Queries and corpus rows: N(0, 1) with unit queries ("real") or
    queries of norm 1000 ("scaled", so that the levels=0 sums are large
    and their truncation shows), or integers in [-9, 9] ("int")."""
    r = np.random.default_rng(seed)
    if kind == "int":
        return (r.integers(-9, 10, (M, dim)).astype(np.float32),
                r.integers(-9, 10, (n, dim)).astype(np.float32))
    q = r.standard_normal((M, dim)).astype(np.float32)
    c = r.standard_normal((n, dim)).astype(np.float32)
    norm = 1000.0 if kind == "scaled" else 1.0
    return q * (norm / np.linalg.norm(q, axis=1, keepdims=True)), c


def _operands(tool, mode, kind, n, tn, posu):
    """(JAX operands, port operands, port core) of one case."""
    q, c = _data(kind, n, DIM, seed=n + tn + len(mode))
    qj, qt = _split(q)
    r = np.random.default_rng(5)
    if tool == "exp_floor":
        if kind != "int":
            c = c / np.linalg.norm(c, axis=1, keepdims=True)
        cj, ct = _split(c)
        cb = np.zeros((1, n), np.float32)
        return (qj, cj, jnp.asarray(cb)), (qt, ct, torch.from_numpy(cb)), \
            "bf16x3"
    if mode in ("int8", "build"):
        codes, scales = PI._host_quantize_int8(torch.from_numpy(c))
        core = "int8c"
    else:
        codes, scales = PI._host_quantize_int4(torch.from_numpy(c))
        core = {"i32": "int4c", "rint": "int4-rint", "raw": "int4-raw"}[mode]
    if kind == "int":
        # Exact scores: powers of two times integer sums, plus integers.
        cb = np.stack([2.0 ** -r.integers(0, 4, n),
                       r.integers(-3, 4, n)]).astype(np.float32)
    else:
        bias = (F.prepare_int8_bias if core == "int8c"
                else F.prepare_int4_bias)
        cb = bias(codes, scales, "cosine", n).numpy()
    if mode == "rint":
        codes = D.repack_int4_rint(codes)
    cn = codes.numpy()
    return ((qj, jnp.asarray(cn), jnp.asarray(cb)),
            (qt, codes, torch.from_numpy(cb)), core)


# (tool, kernel, mode, levels, ids, posu, n, tn, data)
CASES = [
    ("exp_floor", "_kernel_ab", "ab", 0, "global", False, 1024, 256, "int"),
    ("exp_floor", "_kernel_ab", "ab", 0, "global", False, 1024, 256,
     "scaled"),
    ("exp_floor", "_kernel_ab", "ab", 1, "global", False, 1024, 256, "real"),
    ("exp_floor", "_kernel_ab", "ab", 4, "global", False, 1024, 256, "real"),
    ("exp_b256", "_kernel_build", "build", 0, "segmented", False, 1024, 256,
     "int"),
    ("exp_b256", "_kernel_build", "build", 0, "segmented", False, 1024, 256,
     "scaled"),
    ("exp_b256", "_kernel_build", "build", 2, "segmented", False, 1024, 256,
     "real"),
    ("exp_b256", "_kernel_build", "build", 2, "segmented", True, 1024, 256,
     "real"),
    ("exp_b256", "_kernel_build", "build", 0, "segmented", False, 40960,
     2048, "int"),
    ("exp_b256", "_kernel_build", "build", 2, "segmented", False, 40960,
     2048, "real"),
    ("exp_b256", "_kernel_build", "build", 2, "segmented", True, 40960, 2048,
     "real"),
    ("exp_b256", "_kernel_build", "build", 2, "segmented", False, 18432,
     1536, "real"),
] + [("exp_int4", "_kernel_mm", mode, 1, "tile-local", False, 1024, 256,
      "real") for mode in ("int8", "i32", "rint", "raw")]


@pytest.mark.parametrize(
    "tool,kernel,mode,levels,ids,posu,n,tn,kind", CASES,
    ids=[f"{c[1]}-{c[2]}-L{c[3]}-{'posu-' if c[5] else ''}n{c[6]}-tn{c[7]}"
         f"-{c[8]}" for c in CASES])
def test_plain_matches_jax_kernel(tool, kernel, mode, levels, ids, posu, n,
                                  tn, kind):
    jops, tops, core = _operands(tool, mode, kind, n, tn, posu)
    kw = {"levels": levels} if tool != "exp_int4" else {"mode": mode}
    if tool == "exp_b256":
        kw["posu"] = posu
    want = _run_jax(getattr(_tool(tool), kernel), *jops, tn,
                    max(levels, 1), **kw)
    tm, splits, tps = D.floor_geometry(M, n, core, levels, 10, CPU)
    got, lv = D.floor_stacks(*tops, core=core, levels=levels, tn=tn, ids=ids,
                             posu=posu, k_geometry=10)
    got, lv = got.numpy(), lv.numpy()
    assert got.shape == (M, 128) and got.dtype == np.int32
    s = D.floor_scores_plain(*tops, core, 0, n).numpy()
    if levels == 0:
        np.testing.assert_array_equal(got, want)
        assert np.abs(want).max() > 0, "the sums are all zero"
        maxima = s.reshape(M, -1, tn).max(axis=2)
        np.testing.assert_array_equal(lv, _np_pack(maxima, 1, "none", False))
        np.testing.assert_array_equal(
            got[:, 0], np.trunc(maxima).astype(np.int64).sum(axis=1))
        return
    assert lv.shape == (M, splits, levels, 128)
    # Level 0 against the JAX kernel.
    a, b = _decoded(got, posu), _decoded(want, posu)
    tol = 2.0 ** -15 * np.abs(b) + 1e-6
    assert np.all(np.abs(a - b) <= tol), np.abs(a - b).max()
    p = _np_pack(s, tn, ids, posu)
    seg = D.segment_rows(tn)
    final = _np_cells(p, (n - 1) // seg * seg if ids == "segmented" else 0,
                      n, 2)
    best = _decoded(final, posu)
    clear = np.abs(best[:, 0] - best[:, 1]) > 2.0 ** -15 * np.abs(
        best[:, 0]) + 1e-6
    np.testing.assert_array_equal((got & 127)[clear], (want & 127)[clear])
    # Every split's every level against a NumPy sort of each cell.
    np.testing.assert_array_equal(got, final[:, 0])
    np.testing.assert_array_equal(
        lv, _np_split_levels(p, n, tn, ids, levels, splits, tps))


def test_jax_helpers_copied():
    """_f32_to_u, _gstack_depth and _gstack_geometry equal the JAX
    package's."""
    bits = np.random.default_rng(0).integers(-2 ** 31, 2 ** 31, 4096,
                                             dtype=np.int64).astype(np.int32)
    np.testing.assert_array_equal(
        D._f32_to_u(torch.from_numpy(bits)).numpy(),
        np.asarray(JF._f32_to_u(jnp.asarray(bits))))
    for groups in (1, 2, 80, 96, 128, 129, 15_632, 78_125):
        for k in (1, 10, 16, 64, 100, 128, 200, 512):
            assert D._gstack_geometry(groups, k) == tuple(
                int(x) for x in JF._gstack_geometry(groups, k)), (groups, k)
    for k, cells in ((10, 128), (100, 15_744), (300, 256)):
        assert D._gstack_depth(k, cells) == JF._gstack_depth(k, cells)


def test_int4_host_helpers_match_exp_int4():
    """The port's exp_int4 quantizers and ``repack_int4_rint`` against the
    JAX experiment's host prep (``_prep``, one chunk at a small width)."""
    ei = _tool("exp_int4")
    ei.N, ei.DIM = 250_000, 32   # _prep draws chunks of 250,000 rows
    cp8, cb8, cp4, cb4, cpa = ei._prep(ei.N)
    c = np.random.default_rng(500).standard_normal((250_000, 32)).astype(
        np.float32)
    codes8, scales8 = PI._host_quantize_int8(torch.from_numpy(c))
    codes4, scales4 = PI._host_quantize_int4(torch.from_numpy(c))
    want8, want_s8 = ei._host_quantize_int8(c)
    want4, want_s4 = ei._host_quantize_int4(c, 32)
    np.testing.assert_array_equal(codes8.numpy(), cp8)
    np.testing.assert_array_equal(codes8.numpy(), want8)
    np.testing.assert_array_equal(scales8.numpy(), want_s8)
    np.testing.assert_array_equal(codes4.numpy(), cp4)
    np.testing.assert_array_equal(codes4.numpy(), want4)
    np.testing.assert_array_equal(scales4.numpy(), want_s4)
    np.testing.assert_array_equal(D.repack_int4_rint(codes4).numpy(), cpa)
    ones = torch.ones(250_000)
    np.testing.assert_allclose(
        F.prepare_int8_bias(codes8, ones, "cosine", 250_000).numpy(), cb8,
        rtol=1e-6)
    np.testing.assert_allclose(
        F.prepare_int4_bias(codes4, ones, "cosine", 250_000).numpy(), cb4,
        rtol=1e-6)


def test_int4_decodes():
    """On repacked bytes the int4-rint decode gives int4c's nibbles, so
    the same scores; int4-raw reads each byte in both nibble positions."""
    q, c = _data("real", 256, DIM, seed=3)
    _, qt = _split(q)
    codes, scales = PI._host_quantize_int4(torch.from_numpy(c))
    cb = F.prepare_int4_bias(codes, scales, "cosine", 256)
    repacked = D.repack_int4_rint(codes)
    assert torch.equal(D._decoded_corpus(repacked, "int4-rint"),
                       D._decoded_corpus(codes, "int4c"))
    assert torch.equal(D.floor_scores_plain(qt, repacked, cb, "int4-rint",
                                            0, 256),
                       D.floor_scores_plain(qt, codes, cb, "int4c", 0, 256))
    raw = D._decoded_corpus(codes, "int4-raw")
    assert torch.equal(raw, torch.cat([codes.float()] * 2, dim=1))
    # Every byte, repacked or not: hi = rint(b / 16), ties to even.
    b = np.arange(-128, 128, dtype=np.int8)[None]
    hi = np.rint(b / 16.0)
    got = D._decoded_corpus(torch.from_numpy(b), "int4-rint").numpy()
    np.testing.assert_array_equal(got, np.concatenate([b - 16 * hi, hi], 1))


@pytest.mark.parametrize("n,ids,tn", [(128 * 129, "global", 256),
                                      (1024, "segmented", 32768),
                                      (1024, "tile-local", 32768)])
def test_ids_past_seven_bits_raise(n, ids, tn):
    """More than 128 global groups (the JAX kernel packs 127 - g < 0), or a
    tile of more than 128 groups, raise ValueError."""
    q, c = _data("real", n, DIM, seed=2)
    _, qt = _split(q)
    _, ct = _split(c)
    cb = torch.zeros((1, n))
    with pytest.raises(ValueError, match="ids? "):
        D.floor_stacks(qt, ct, cb, core="bf16x3", levels=1, tn=tn, ids=ids)
    # levels=0 packs no ids: the same operands run.
    D.floor_stacks(qt, ct, cb, core="bf16x3", levels=0, tn=256 if
                   ids == "global" else 1024, ids=ids)
