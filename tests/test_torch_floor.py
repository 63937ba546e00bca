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


def _run_jax(kernel, q, c, cb, tn, scratch, tm=TM, **kw):
    """One ``tools/`` kernel in interpret mode, the BlockSpecs of its
    ``measure*`` function (query tile ``tm``)."""
    m, n = q.shape[0], c.shape[0]
    call = pl.pallas_call(
        functools.partial(kernel, tm=tm, tn=tn, **kw),
        grid=(m // tm, n // tn),
        in_specs=[
            pl.BlockSpec((tm, q.shape[1]), lambda i, j: (i, 0)),
            pl.BlockSpec((tn, c.shape[1]), lambda i, j: (j, 0)),
            pl.BlockSpec((cb.shape[0], tn), lambda i, j: (0, j)),
        ],
        out_specs=[pl.BlockSpec((tm, 128), lambda i, j: (i, 0))],
        out_shape=[jax.ShapeDtypeStruct((m, 128), jnp.int32)],
        scratch_shapes=[pltpu.VMEM((scratch, tm, 128), jnp.int32)],
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


def _data(kind, n, dim, seed, m=M):
    """Queries and corpus rows: N(0, 1) with unit queries ("real") or
    queries of norm 1000 ("scaled", so that the levels=0 sums are large
    and their truncation shows), or integers in [-9, 9] ("int")."""
    r = np.random.default_rng(seed)
    if kind == "int":
        return (r.integers(-9, 10, (m, dim)).astype(np.float32),
                r.integers(-9, 10, (n, dim)).astype(np.float32))
    q = r.standard_normal((m, dim)).astype(np.float32)
    c = r.standard_normal((n, dim)).astype(np.float32)
    norm = 1000.0 if kind == "scaled" else 1.0
    return q * (norm / np.linalg.norm(q, axis=1, keepdims=True)), c


def _operands(tool, mode, kind, n, tn, posu, m=M):
    """(JAX operands, port operands, port core) of one case."""
    q, c = _data(kind, n, DIM, seed=n + tn + len(mode), m=m)
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
    _check_against_jax(tool, kernel, mode, levels, ids, posu, n, tn, kind)


def _check_against_jax(tool, kernel, mode, levels, ids, posu, n, tn, kind,
                       m=M, jax_tm=TM):
    """``floor_stacks`` on CPU tensors (the plain version at kernel D's
    geometry for m queries) against the JAX kernel (query tile jax_tm);
    returns the geometry."""
    jops, tops, core = _operands(tool, mode, kind, n, tn, posu, m=m)
    kw = {"levels": levels} if tool != "exp_int4" else {"mode": mode}
    if tool == "exp_b256":
        kw["posu"] = posu
    want = _run_jax(getattr(_tool(tool), kernel), *jops, tn,
                    max(levels, 1), tm=jax_tm, **kw)
    tm, splits, tps = D.floor_geometry(m, n, core, levels, 10, CPU,
                                       dim=tops[0].shape[1] // 2)
    got, lv = D.floor_stacks(*tops, core=core, levels=levels, tn=tn, ids=ids,
                             posu=posu, k_geometry=10)
    got, lv = got.numpy(), lv.numpy()
    assert got.shape == (m, 128) and got.dtype == np.int32
    s = D.floor_scores_plain(*tops, core, 0, n).numpy()
    if levels == 0:
        np.testing.assert_array_equal(got, want)
        assert np.abs(want).max() > 0, "the sums are all zero"
        maxima = s.reshape(m, -1, tn).max(axis=2)
        np.testing.assert_array_equal(lv, _np_pack(maxima, 1, "none", False))
        np.testing.assert_array_equal(
            got[:, 0], np.trunc(maxima).astype(np.int64).sum(axis=1))
        return tm, splits, tps
    assert lv.shape == (m, splits, levels, 128)
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
    return tm, splits, tps


# Kernel D's tile-64 geometry (64 queries; the JAX kernels at query tile
# 32): (tool, kernel, mode, levels, ids, posu, n, tn, data).  tn = 640
# restarts the segmented stacks every 16,000 rows, inside a 256-row step
# of the split that holds row 16,000.
WG_CASES = [
    ("exp_b256", "_kernel_build", "build", 0, "segmented", False, 19200, 640,
     "int"),
    ("exp_b256", "_kernel_build", "build", 1, "segmented", False, 19200, 640,
     "real"),
    ("exp_b256", "_kernel_build", "build", 2, "segmented", True, 19200, 640,
     "real"),
    ("exp_b256", "_kernel_build", "build", 3, "segmented", False, 19200, 640,
     "real"),
    ("exp_int4", "_kernel_mm", "i32", 1, "tile-local", False, 1280, 640,
     "real"),
    ("exp_int4", "_kernel_mm", "rint", 1, "tile-local", False, 1280, 640,
     "real"),
    ("exp_floor", "_kernel_ab", "ab", 1, "global", False, 1280, 640, "real"),
]


@pytest.mark.parametrize(
    "tool,kernel,mode,levels,ids,posu,n,tn,kind", WG_CASES,
    ids=[f"{c[1]}-{c[2]}-L{c[3]}-{'posu-' if c[5] else ''}n{c[6]}-tn{c[7]}"
         f"-{c[8]}" for c in WG_CASES])
def test_plain_at_tile64_geometry_matches_jax_kernel(
        tool, kernel, mode, levels, ids, posu, n, tn, kind):
    """The plain version at the splits of kernel D's tile-64 launch (the
    warpgroup consumer for the stored cores at levels 0-3, the ring for
    bf16x3) against the JAX kernels; the segmented cases restart a
    segment inside a 256-row step."""
    core = {"ab": "bf16x3", "build": "int8c", "i32": "int4c",
            "rint": "int4-rint"}[mode]
    tm, splits, tps = _check_against_jax(tool, kernel, mode, levels, ids,
                                         posu, n, tn, kind, m=64, jax_tm=32)
    assert tm == 64
    wgmma = core != "bf16x3" and levels <= 3
    assert D.floor_consumer(tm, core, levels) == ("wgmma" if wgmma
                                                 else "ring")
    if ids == "segmented":
        b = D.segment_rows(tn) // 64   # the restart's kernel tile
        assert D.segment_rows(tn) == 16000 and b < -(-n // 64)
        t0 = b // tps * tps            # its split's first tile
        assert t0 < b and (b - t0) % F.WG_TILES, (splits, tps)


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


# The source's shared memory (csrc/floor.cu, csrc/ring_wgmma.cuh): a
# wgmma stage is 256 corpus rows at their box pitch (int8 64 bytes, int4
# 32) and four query boxes of 64 rows x 16 bf16, hi and lo; a ring of two
# of them takes 1024 bytes more to align its first stage and 128 for the
# barriers; the tail is four score tiles of 64 x 65 floats.
_WG_STAGE = {"int8c": 256 * 64 + 2 * 4 * 64 * 32,
             "int4c": 256 * 32 + 2 * 4 * 64 * 32}
_WG_RING = {core: 1024 + 2 * stage + 128 for core, stage in _WG_STAGE.items()}
_WG_TAIL = 4 * 64 * 65 * 4


@pytest.mark.parametrize("core", D.CORES)
@pytest.mark.parametrize("tm", (16, 32, 64))
def test_floor_consumer(tm, core):
    """The warpgroup consumer for the four stored cores at query tile 64
    wherever two stages fit beside D's tail (one stack level in
    registers, deeper stacks in shared memory), the mma.sync ring
    everywhere else; the geometry keeps the query tile while a consumer
    fits."""
    ring = _WG_RING["int8c" if core == "int8c" else "int4c"]
    for levels in range(0, 7):
        stacks = 0 if levels <= 1 else levels * 64 * 128 * 4
        fits = ring + _WG_TAIL + stacks <= 232448
        want = ("wgmma" if tm == 64 and core != "bf16x3" and fits
                else "ring")
        assert D.floor_consumer(tm, core, levels) == want, levels
        assert D.floor_plan(tm, core, levels, 768)[0] == want
    if tm == 64 and core != "bf16x3":
        deepest = 3
        assert D.floor_consumer(64, core, deepest) == "wgmma"
        assert D.floor_consumer(64, core, deepest + 1) == "ring"
    m = {16: 9, 32: 20, 64: 256}[tm]
    for levels in (0, 1, 2, 5):
        got = D.floor_geometry(m, 2_000_000, core, levels, 100, CPU,
                               dim=256)[0]
        assert got == tm, (levels, got)


@pytest.mark.parametrize("core", ("int8c", "int4c", "int4-rint"))
@pytest.mark.parametrize("levels", (0, 1, 2, 3))
def test_floor_plan_wgmma_stages(core, levels):
    """The warpgroup consumer's ring in kernel D: the most stages (up to
    eight) whose ring, 1024 bytes of alignment, the stages and 128 bytes
    of barriers, fits beside D's tail; its shared memory is that ring and
    the tail."""
    stage = _WG_STAGE["int8c" if core == "int8c" else "int4c"]
    stacks = 0 if levels <= 1 else levels * 64 * 128 * 4
    tail = _WG_TAIL + stacks
    want = max(s for s in range(2, 9)
               if 1024 + s * stage + 128 + tail <= 232448)
    plan = D.floor_plan(64, core, levels, 768)
    assert plan[:5] == ("wgmma", core, want, stage, False)
    assert plan[5] == 1024 + want * stage + 128 + tail


def test_smem_bytes_match_the_source():
    """``smem_bytes`` (two stages of the launch's consumer, then its tail)
    against the source's arithmetic, written out: the wgmma consumer, the
    mma.sync ring, and register stacks (one level beside wgmma, two on
    the ring but none at query tile 64 or for int4 at 32) and the
    levels=0 maxima, which take no shared memory."""
    tile64 = 64 * 65 * 4
    # wgmma: the ring of two stages, four score tiles, and stacks from two
    # levels.
    assert D.smem_bytes(64, "int8c", 0) == _WG_RING["int8c"] + _WG_TAIL \
        == 133248
    assert D.smem_bytes(64, "int8c", 1) == 133248
    assert D.smem_bytes(64, "int8c", 2) == 133248 + 2 * 64 * 128 * 4
    assert D.smem_bytes(64, "int4-raw", 1) == _WG_RING["int4c"] + _WG_TAIL
    assert D.smem_bytes(64, "int4c", 3) == 215168
    # The tile-64 ring (int8: 32 bytes a row -> 48, 32 query columns of 64
    # bytes -> 96 a row), five levels in shared memory.
    assert D.smem_bytes(64, "int8c", 5) == 2 * (64 * 48 + 2 * 64 * 96) \
        + tile64 + 5 * 64 * 128 * 4 == 211200
    # bf16x3 on the ring, 32 features a position: 128 bytes a row -> 144,
    # the query's 32 columns 64 bytes -> 80.
    assert D.smem_bytes(16, "bf16x3", 1) == 2 * (64 * 144 + 2 * 16 * 80) \
        + 16 * 65 * 4 == 27712 == D.smem_bytes(16, "bf16x3", 0)
    assert D.smem_bytes(64, "bf16x3", 1) == 2 * (64 * 144 + 2 * 64 * 80) \
        + tile64 + 64 * 128 * 4
    assert D.smem_bytes(64, "bf16x3", 4) == 2 * (64 * 144 + 2 * 64 * 80) \
        + tile64 + 4 * 64 * 128 * 4
    # int8 at tile 32: 64 bytes a row -> 80, 64 columns of 128 bytes ->
    # 160; levels 1 and 2 in registers.
    for levels in (1, 2):
        assert D.smem_bytes(32, "int8c", levels) == 2 * (64 * 80 + 2 * 32
                                                         * 160) \
            + 32 * 65 * 4 == 39040
    assert D.smem_bytes(32, "int8c", 3) == 39040 + 3 * 32 * 128 * 4
    # int4 at tile 32 (32 bytes a row -> 48, 64 columns -> 160): its
    # stacks stay in shared memory.
    assert D.smem_bytes(32, "int4c", 1) == 2 * (64 * 48 + 2 * 32 * 160) \
        + 32 * 65 * 4 + 32 * 128 * 4 == 51328
    most = {(64, "int8c", "wgmma"): 1, (16, "int4c", "ring"): 2,
            (32, "int4-rint", "ring"): 0, (32, "int8c", "ring"): 2,
            (64, "bf16x3", "ring"): 0, (64, "int8c", "ring"): 0}
    for (tm, core, consumer), n in most.items():
        assert D.reg_max(tm, core, consumer) == n
        for levels in range(0, 6):
            assert D.register_levels(tm, core, levels, consumer) == (
                levels if 1 <= levels <= n else 0)


def test_floor_plan_wide_ring_and_narrowing():
    """bf16x3 streams 64 features a position at query tiles 16 and 64
    where that ring keeps two blocks an SM (kernel A's ``ring_core`` rule
    on D's tail), 32 at tile 32 and beside stacks in shared memory at tile
    64; a stack that fits no consumer at tile 64 narrows the query
    tile."""
    assert D.floor_plan(64, "bf16x3", 0, 256)[1:3] == ("bf16x3w", 2)
    assert D.floor_plan(16, "bf16x3", 1, 256)[1] == "bf16x3w"
    assert D.floor_plan(32, "bf16x3", 1, 256)[1] == "bf16x3"
    for levels in (1, 2, 5):
        assert D.floor_plan(64, "bf16x3", levels, 256)[1] == "bf16x3"
    for core, levels in (("bf16x3", 8), ("int8c", 8), ("int4c", 10)):
        assert D.smem_bytes(64, core, levels) > 232448
        tm = D.floor_geometry(256, 100_000, core, levels, 100, CPU,
                              dim=256)[0]
        assert tm < 64 and D.smem_bytes(tm, core, levels) <= 232448


def test_ab_floor_tool():
    """``tools/ab_floor.py`` (kernel D, parent against change on the card)
    imports nothing of JAX, refuses to run without a card, patches this
    tree's source once a variant, and times every kernel D launch of the
    three experiments (27: each level, batch and mode, and levels 0 at
    each shape)."""
    import os
    import re
    import subprocess
    import sys

    root = Path(__file__).resolve().parents[1]
    code = ("import sys; import polars_matmul_tpu_torch.tools.ab_floor; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'polars_matmul_tpu' or "
            "m.startswith('polars_matmul_tpu.')]; assert not bad, bad")
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=str(root)))
    assert r.returncode == 0, r.stderr
    from polars_matmul_tpu_torch.kernels import _build
    from polars_matmul_tpu_torch.tools import ab_floor

    src = (_build._CSRC / "floor.cu").read_text()
    for name, patches in ab_floor.VARIANTS.items():
        for pattern, replacement in patches:
            text, hits = re.subn(pattern, replacement, src, count=1)
            assert hits == 1 and text != src, name
    launches = list(ab_floor.entries(CPU))
    assert len(launches) == 27
    assert {e[3] for e in launches} == set(D.CORES)
    assert {e[4] for e in launches} >= {0, 1, 4, 5}
    assert ab_floor.parent_smem(64, "int8c", 5) == D.smem_bytes(
        64, "int8c", 5)   # the tile-64 ring with stacks in shared memory
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        ab_floor.main(root / "build" / "parent")
