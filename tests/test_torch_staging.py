"""The stored cores' ring plan (``kernels/fused_topk.py`` ``ring_plan``, the
host mirror of ``csrc/tile_scores.cuh``) and the bit-level decodes the
ring applies as it reads bytes out.

Kernel A cannot run here; these check what the host decides for it: the
bytes a stage holds, where the query tile stays resident, that every plan
fits a block's shared memory, and kernel D's narrowing of its query tile
on the same ring.  The decodes are checked as arithmetic identities over
every value a byte or a nibble can hold.
"""

import numpy as np
import pytest
import torch

from polars_matmul_tpu_torch.kernels import floor as D
from polars_matmul_tpu_torch.kernels import fused_topk as F

STORED = ("bf16c", "int8c", "int4c")
DIMS = (3, 56, 100, 256, 300, 768, 4200, 8192)


def _blocks(nbytes):
    return F._SMEM_PER_SM // (nbytes + F._SMEM_PER_BLOCK)


@pytest.mark.parametrize("tm,core,want", [
    (16, "bf16c", 256), (16, "int8c", 256), (16, "int4c", 128),
    (32, "bf16c", 128), (32, "int8c", 64), (32, "int4c", 32),
    (64, "bf16c", 64), (64, "int8c", 32), (64, "int4c", 16),
])
def test_ring_row_bytes(tm, core, want):
    """A 16-row tile stages 256 bytes a row (int4 128); taller tiles meet
    the same query columns a stage in every core: 64 at tm 32, 32 at tm
    64."""
    assert F.ring_row_bytes(tm, core) == want
    cols = want // 2 if core == "bf16c" else 2 * want if core == "int4c" \
        else want
    if tm > 16:
        assert cols == {32: 64, 64: 32}[tm]


def test_stage_bytes_at_batch_8_dim_768():
    """int8 at tm 16: 64 rows of 256 bytes (stride 272) a stage; the
    resident query tile is 16 rows x (768 + 16) bf16, hi and lo."""
    stage, staging = F.ring_staging(16, "int8c", 768, True, 3)
    assert stage == 64 * 272
    assert staging == 3 * stage + 2 * 16 * 784 * 2
    stage, staging = F.ring_staging(16, "int8c", 768, False, 2)
    assert stage == 64 * 272 + 2 * 16 * 272 * 2
    assert staging == 2 * stage


@pytest.mark.parametrize("core,k,want", [
    ("int8c", 10, (3, True)), ("int8c", 100, (2, True)),
    ("int4c", 10, (4, True)), ("int4c", 100, (4, True)),
    ("bf16c", 10, (3, True)), ("bf16c", 100, (3, False)),
])
def test_batch_8_plan(core, k, want):
    """Two blocks an SM first, then the most stages, then the query tile
    resident: at batch 8, dim 768."""
    stages, _, resident, smem = F.ring_plan(
        16, core, F._corpus_width(core, 768), F.tail_bytes(16, k))
    assert (stages, resident) == want
    assert _blocks(smem) == 2


@pytest.mark.parametrize("core", ("int8c", "int4c"))
@pytest.mark.parametrize("k", (1, 10, 100, 512, 1024))
def test_batch_8_query_is_resident(core, k):
    """The north-star batch-8 cells stage their query once a block, at
    every k (int8 and int4)."""
    c_ld = F._corpus_width(core, 768)
    tm = F.query_tile_rows(8, k)
    assert tm == 16
    assert F.ring_plan(tm, core, c_ld, F.tail_bytes(tm, k))[2]


@pytest.mark.parametrize("core", STORED)
def test_batch_256_rides_the_ring_two_blocks_an_sm(core):
    """At tm 64 the query columns ride the ring, and two blocks an SM fit
    beside the carry at k = 100, as they did before the ring."""
    c_ld = F._corpus_width(core, 768)
    stages, _, resident, smem = F.ring_plan(64, core, c_ld,
                                            F.tail_bytes(64, 100))
    assert stages == F.ring_stages(64, core) and not resident
    assert _blocks(smem) >= 2


@pytest.mark.parametrize("core", STORED)
@pytest.mark.parametrize("dim", DIMS)
def test_every_plan_fits_and_costs_no_block(core, dim):
    c_ld = F._corpus_width(core, dim)
    for k in (1, 10, 100, 128, 129, 256, 257, 512, 1024):
        for m in (1, 16, 17, 32, 33, 256):
            tm = F.query_tile_rows(m, k)
            rest = F.tail_bytes(tm, k)
            stages, _, resident, smem = F.ring_plan(tm, core, c_ld, rest)
            assert stages >= 2 and smem <= F.MAX_SMEM, (tm, k, dim)
            best = max(min(_blocks(F.ring_staging(
                tm, core, c_ld, res, st)[1] + rest), 2)
                for res in ((False,) if tm == 64 else (True, False))
                for st in range(2, F.ring_stages(tm, core) + 1))
            assert not (resident and tm == 64)
            assert min(_blocks(smem), 2) == best
            assert smem == F.ring_staging(tm, core, c_ld, resident,
                                          stages)[1] + rest


def test_kernel_d_narrows_on_the_ring():
    """Kernel D's query tile narrows where its stacks and ring do not fit:
    five levels at tm 64 fit beside the int8 ring; sixteen do not."""
    assert D.smem_bytes(64, "int8c", 5) <= D._MAX_SMEM
    assert D.smem_bytes(64, "int8c", 16) > D._MAX_SMEM
    cpu = torch.device("cpu")
    assert D.floor_geometry(256, 1 << 20, "int8c", 5, 100, cpu,
                            dim=256)[0] == 64
    assert D.floor_geometry(256, 1 << 20, "int8c", 16, 100, cpu,
                            dim=256)[0] < 64
    assert D.corpus_width("int4-rint", 768) == 384


def _bf16_value(bits):
    """f32 values of bf16 bit patterns (uint16)."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def test_int8_decode_is_exact():
    """bf16 bits 0x4300 | (b & 127) are 128 + (b & 127); less 128, or 256
    where the sign bit is set (bits 0x4300 | (b & 128)), they give the
    signed byte v exactly."""
    v = np.arange(-128, 128, dtype=np.int32)
    b = v.astype(np.uint8).astype(np.uint16)
    x = _bf16_value((b & 0x7F) | 0x4300)
    c = _bf16_value((b & 0x80) | 0x4300)
    assert set(np.unique(c)) == {128.0, 256.0}
    got = (torch.from_numpy(x).to(torch.bfloat16)
           - torch.from_numpy(c).to(torch.bfloat16)).float().numpy()
    assert np.array_equal(got, v.astype(np.float32))


def test_int8_float_decode_is_exact():
    """int4-rint's decode: 2^23 + (v + 128) built in the f32 bits, less
    2^23 + 128, is v; its bf16 rounding is v again."""
    v = np.arange(-128, 128, dtype=np.int32)
    u = (v.astype(np.uint8) ^ 0x80).astype(np.uint32)
    f = (0x4B000000 | u).view(np.float32) - np.float32(8388736.0)
    assert np.array_equal(f, v.astype(np.float32))
    rounded = torch.from_numpy(f).to(torch.bfloat16).float().numpy()
    assert np.array_equal(rounded, f)


def test_int4_decode_is_exact():
    """bf16 bits 0x4300 | (n ^ 8) are 136 + v for the signed nibble v of
    n, and one bf16 fma (x * 1 - 136) gives v exactly."""
    n = np.arange(16, dtype=np.uint16)
    v = np.where(n >= 8, n.astype(np.int32) - 16, n.astype(np.int32))
    bits = ((n & 0xF) ^ 0x4308).astype(np.uint16)
    assert np.array_equal(_bf16_value(bits), 136.0 + v)
    x = torch.from_numpy(_bf16_value(bits)).to(torch.bfloat16)
    got = torch.addcmul(torch.full_like(x, -136.0), x,
                        torch.ones_like(x)).float().numpy()
    assert np.array_equal(got, v.astype(np.float32))
    assert _bf16_value(np.array([0xC308], np.uint16))[0] == -136.0


@pytest.mark.parametrize("half", [64, 128, 192, 384, 1024, 1536, 2048, 4096])
def test_int4_chunk_of_a_byte_without_division(half):
    """The ring finds a byte's int4 feature chunk as trunc(b * (1 / half))
    corrected by one either way, in f32: equal to b // half for every
    16-byte group of rows up to 2^20 bytes."""
    b = np.arange(0, 1 << 20, 16, dtype=np.int64)
    inv = np.float32(1.0) / np.float32(half)
    t = np.trunc(b.astype(np.float32) * inv).astype(np.int64)
    t += (t + 1) * half <= b
    t -= t * half > b
    assert np.array_equal(t, b // half)


# Kernel A's stored cores at query tile 64: the warpgroup consumer
# (``csrc/ring_wgmma.cuh``) on the same ring.


@pytest.mark.parametrize("core,cols,row_bytes,want", [
    ("bf16c", 48, 96, 256 * 112 + 2 * 64 * 48 * 2),
    ("int8c", 64, 64, 256 * 80 + 2 * 64 * 64 * 2),
    ("int4c", 64, 32, 256 * 48 + 2 * 64 * 64 * 2),
])
def test_wgmma_stage_bytes(core, cols, row_bytes, want):
    """A stage holds 256 corpus rows (four kernel tiles, two a warpgroup)
    at an odd number of 16-byte units a row, then the hi and lo query
    columns they meet (whole k16 steps; int4 whole 16-byte groups)."""
    assert (F.wg_cols(core), F.wg_row_bytes(core)) == (cols, row_bytes)
    assert F.wg_stage_bytes(core) == want and want % 16 == 0
    assert F.WG_TILES * F._TN == 256 and cols % 16 == 0


@pytest.mark.parametrize("core", STORED)
@pytest.mark.parametrize("k", (1, 10, 100, 128))
def test_wgmma_plan_one_block_an_sm(core, k):
    """The warpgroup consumer runs one block an SM (its accumulators take
    up to 255 registers a thread), with the most stages that fit beside
    the carry."""
    stages, stage, resident, smem = F.wg_plan(core, k)
    assert not resident
    assert 2 <= stages <= F.WG_STAGES and smem <= F.MAX_SMEM
    assert _blocks(smem) == 1
    assert smem == stages * stage + F.wg_tail_bytes(k)
    assert (stages == F.WG_STAGES
            or (stages + 1) * stage + F.wg_tail_bytes(k) > F.MAX_SMEM)


@pytest.mark.parametrize("core", STORED)
def test_wgmma_plan_fits_every_tile_64_k(core):
    """Every k a 64-row query tile takes (1-128) has a ring of at least two
    stages at dim 768, the plan the source's pmm_fused_topk_ring reports
    for tm 64."""
    c_ld = F._corpus_width(core, 768)
    for k in range(1, 129):
        assert F.query_tile_rows(256, k) == 64
        stages, _, _, smem = F.stage_plan(64, core, c_ld, k)
        assert stages >= 2 and smem <= F.MAX_SMEM, k
    assert F.query_tile_rows(256, 129) < 64


@pytest.mark.parametrize("core,k,want", [
    ("int8c", 10, 4), ("int8c", 100, 3), ("int8c", 128, 2),
    ("int4c", 10, 5), ("int4c", 100, 3), ("int4c", 128, 3),
    ("bf16c", 10, 3), ("bf16c", 100, 2), ("bf16c", 128, 2),
])
def test_wgmma_plan_stages(core, k, want):
    """The stages of the north-star cells: the ring deferring each
    stage's wait (three stages or more) everywhere but bf16c past k = 10
    and int8 at k = 128."""
    assert F.wg_plan(core, k)[0] == want


@pytest.mark.parametrize("core", STORED)
def test_stage_plan_below_tile_64_is_the_mma_ring(core):
    c_ld = F._corpus_width(core, 768)
    for tm, k in ((16, 10), (16, 1024), (32, 256)):
        assert F.stage_plan(tm, core, c_ld, k) == F.ring_plan(
            tm, core, c_ld, F.tail_bytes(tm, k))


# NumPy models of what csrc/ring_wgmma.cuh computes on the card: where a
# query column lands in a stage (wg_query_offset), each k16 step's matrix
# descriptor fields, and the feature a stage column holds (wg_feature).


def _query_offset(core, row, col):
    """Element offset of query (row, column) in a stage's hi or lo
    columns: 8-row x 8-column core matrices of 128 bytes, row groups
    outer."""
    return (((row >> 3) * (F.wg_cols(core) >> 3) + (col >> 3)) * 64
            + (row & 7) * 8 + (col & 7))


def _step_descriptor(core, step):
    """(start, leading, stride) byte offsets of k16 step ``step``'s B
    operand: its first core matrix, the next 8 columns, the next 8 rows
    (no swizzle, K-major), as wg_issue builds them."""
    return 256 * step, 128, 16 * F.wg_cols(core)


def _feature(core, kc, col, ck):
    """The feature query column ``col`` of ring chunk ``kc`` holds: in
    order for bf16c and int8; for int4 each 16 stored bytes meet 32
    columns, their low nibbles' features then their high ones' (byte j of
    a ck-wide chunk holds feature j low and j + ck/2 high)."""
    if core != "int4c":
        return kc * F.wg_cols(core) + col
    b, half = kc * F.wg_row_bytes(core) + (col // 32) * 16, ck // 2
    t, w = b // half, col % 32
    return t * ck + (b - t * half) + (half + w - 16 if w >= 16 else w)


@pytest.mark.parametrize("core", STORED)
def test_wgmma_query_layout_is_core_matrices(core):
    """The query columns of a stage: every (row, column) at its own
    offset, 8 columns of a row contiguous (one 16-byte cp.async), a core
    matrix 128 contiguous bytes."""
    cols = F.wg_cols(core)
    r, c = np.meshgrid(np.arange(64), np.arange(cols), indexing="ij")
    off = _query_offset(core, r, c)
    assert sorted(off.ravel()) == list(range(64 * cols))
    assert (off[:, 1:8] - off[:, :1] == np.arange(1, 8)).all()
    assert (off[:, ::8] % 8 == 0).all()
    for rg in range(8):
        for cg in range(cols // 8):
            block = off[8 * rg:8 * rg + 8, 8 * cg:8 * cg + 8]
            assert block.min() % 64 == 0
            assert sorted(block.ravel()) == list(
                range(block.min(), block.min() + 64))


@pytest.mark.parametrize("core", STORED)
def test_wgmma_descriptor_fields_address_the_b_operand(core):
    """Each k16 step's descriptor (start, leading byte offset, stride byte
    offset) addresses query row n, k slot j as the no-swizzle K-major
    canonical layout does: start + (n / 8) SBO + (n % 8) 16 + (j / 8) LBO
    + (j % 8) 2, which must be column 16 step + j of row n."""
    cols = F.wg_cols(core)
    n, j = np.meshgrid(np.arange(64), np.arange(16), indexing="ij")
    for step in range(cols // 16):
        start, lbo, sbo = _step_descriptor(core, step)
        assert start % 16 == 0 and lbo % 16 == 0 and sbo % 16 == 0
        assert max(start, lbo, sbo) >> 4 < 1 << 14   # 14-bit fields
        addr = start + (n // 8) * sbo + (n % 8) * 16 + (j // 8) * lbo \
            + (j % 8) * 2
        assert np.array_equal(addr, 2 * _query_offset(
            core, n, 16 * step + j))


def _a_slot_features(core, kc, step, ck):
    """Model of a thread's A fragment (csrc/ring_wgmma.cuh wg_decode): the
    stored feature in each of the 16 k slots of k16 step ``step`` of ring
    chunk ``kc``, from the stage bytes each thread tig loads: slot pairs
    (2 tig, 2 tig + 1) and (2 tig + 8, 2 tig + 9) are elements e of the
    step (int8: bytes, bf16c: 2-byte elements); int4 steps 2u and 2u + 1
    share the bytes 16u + e, low nibbles then high."""
    rb = F.wg_row_bytes(core)
    out = np.full(16, -1)
    for tig in range(4):
        for e in (2 * tig, 2 * tig + 1, 2 * tig + 8, 2 * tig + 9):
            if core == "int4c":
                byte, half = kc * rb + 16 * (step // 2) + e, ck // 2
                t = byte // half
                out[e] = t * ck + byte - t * half + (half if step % 2 else 0)
            elif core == "bf16c":
                out[e] = kc * (rb // 2) + 16 * step + e
            else:
                out[e] = kc * rb + 16 * step + e
    return out


@pytest.mark.parametrize("core,dim", [
    ("bf16c", 768), ("int8c", 768), ("int4c", 768), ("int4c", 4200),
    ("int4c", 8192)])
def test_wgmma_a_and_b_agree_on_the_k_order(core, dim):
    """For every chunk and k16 step, the feature a thread decodes into A
    slot j is the feature the query column under B slot j holds, int4's
    nibble order across ck-wide chunks included."""
    ck = F.feature_geometry(dim)[0]
    c_ld = F._corpus_width(core, dim)
    row_bytes = c_ld * (2 if core == "bf16c" else 1)
    chunks = -(-row_bytes // F.wg_row_bytes(core))
    seen = set()
    for kc in range(chunks):
        for step in range(F.wg_cols(core) // 16):
            a = _a_slot_features(core, kc, step, ck)
            b = [_feature(core, kc, 16 * step + j, ck) for j in range(16)]
            assert list(a) == b, (kc, step)
            seen.update(b)
    width = 2 * c_ld if core == "int4c" else dim
    assert seen == set(range(width))
