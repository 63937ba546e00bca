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
    assert stages == F.ring_stages(64) and not resident
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
                for st in range(2, F.ring_stages(tm) + 1))
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
