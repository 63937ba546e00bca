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
# (``csrc/ring_wgmma.cuh``) on a ring that TMA loads fill.


@pytest.mark.parametrize("core,cols,row_bytes,want", [
    ("bf16c", 32, 64, 256 * 64 + 2 * 2 * 64 * 32),
    ("int8c", 64, 64, 256 * 64 + 2 * 4 * 64 * 32),
    ("int4c", 64, 32, 256 * 32 + 2 * 4 * 64 * 32),
])
def test_wgmma_stage_bytes(core, cols, row_bytes, want):
    """A stage holds 256 corpus rows (four kernel tiles, two a warpgroup)
    at their box pitch, unpadded, then a hi and a lo query box of 64 rows
    x 16 bf16 for each k16 step of the columns they meet (int4 whole
    16-byte groups); a whole number of 1024-byte units, so every stage
    keeps the first one's alignment."""
    assert (F.wg_cols(core), F.wg_row_bytes(core)) == (cols, row_bytes)
    assert F.wg_stage_bytes(core) == want and want % F.WG_ALIGN == 0
    assert F.WG_TILES * F._TN == 256 and cols % 16 == 0


@pytest.mark.parametrize("core", STORED)
@pytest.mark.parametrize("k", (1, 10, 100, 128))
def test_wgmma_plan_one_block_an_sm(core, k):
    """The warpgroup consumer runs one block an SM (its accumulators take
    up to 255 registers a thread), with the most stages that fit beside
    the carry: the ring's bytes are room to align its first stage, the
    stages, and a full and an empty barrier for each of the most."""
    stages, stage, resident, smem = F.wg_plan(core, k)
    assert not resident
    assert 2 <= stages <= F.WG_STAGES and smem <= F.MAX_SMEM
    assert _blocks(smem) == 1
    ring = F.wg_ring_bytes(core, stages)
    assert ring == 1024 + stages * stage + 2 * F.WG_STAGES * 8
    assert smem == ring + F.wg_tail_bytes(k)
    assert (stages == F.WG_STAGES
            or F.wg_ring_bytes(core, stages + 1) + F.wg_tail_bytes(k)
            > F.MAX_SMEM)


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
    ("int4c", 10, 6), ("int4c", 100, 4), ("int4c", 128, 3),
    ("bf16c", 10, 6), ("bf16c", 100, 4), ("bf16c", 128, 3),
])
def test_wgmma_plan_stages(core, k, want):
    """The stages of the north-star cells, each keeping stages - 1
    positions in flight: int8 at least two, int4 and bf16c (32 columns a
    stage) at least three."""
    assert F.wg_plan(core, k)[0] == want


@pytest.mark.parametrize("core", STORED)
def test_stage_plan_below_tile_64_is_the_mma_ring(core):
    c_ld = F._corpus_width(core, 768)
    for tm, k in ((16, 10), (16, 1024), (32, 256)):
        assert F.stage_plan(tm, core, c_ld, k) == F.ring_plan(
            tm, core, c_ld, F.tail_bytes(tm, k))


# NumPy models of what csrc/ring_wgmma.cuh computes on the card: where a
# stage byte lands (wg_swizzle, the 2-D load's swizzle), each k16 step's
# matrix descriptor, and the feature a query box column holds
# (wg_feature).


def _tma_swizzle(span, offset):
    """The swizzle a 2-D load applies with a box ``span`` bytes wide
    (CU_TENSOR_MAP_SWIZZLE_32B / 64B / 128B), as the CUDA documentation
    states it on the byte offset from an aligned base: the 16-byte piece
    index, bits [4, 4 + w), XORed with bits [7, 7 + w), w = log2(span /
    16)."""
    w = {32: 1, 64: 2, 128: 3}[span]
    mask = (1 << w) - 1
    return offset ^ (((offset >> 7) & mask) << 4)


def _query_offset(core, step, row, col):
    """Byte offset of query (row, column 16 step + col) in a stage's hi (or
    lo) boxes: box ``step`` is 64 rows x 32 bytes, 32-byte swizzle."""
    return step * F.WG_BOX + F.wg_swizzle(32, row, 2 * col)


def _step_descriptor(core, step):
    """(start, leading, stride, layout type) of k16 step ``step``'s B
    operand as wg_desc builds them: the step's box, the leading byte
    offset unused (16), 8 rows of 32 bytes to the next 8, type 3 (32-byte
    swizzle)."""
    return step * F.WG_BOX, 16, 256, 3


@pytest.mark.parametrize("span", (32, 64, 128))
def test_wgmma_swizzle_is_the_tma_pattern(span):
    """wg_swizzle is a bijection of every 8-row group of a box onto
    itself, equal to the documented TMA swizzle of the row-major offset;
    and, per row, the piece order it documents: piece p of row r at p XOR
    (r % 8) for 128 bytes, (r / 2) % 4 for 64, (r / 4) % 2 for 32."""
    rows = 64
    r, b = np.meshgrid(np.arange(rows), np.arange(span), indexing="ij")
    got = F.wg_swizzle(span, r, b)
    assert np.array_equal(got, _tma_swizzle(span, r * span + b))
    assert sorted(got.ravel()) == list(range(rows * span))
    assert np.array_equal(got // (8 * span), r // 8)
    shift = {128: 0, 64: 1, 32: 2}[span]
    piece = ((b // 16) ^ ((r >> shift) % (span // 16))) * 16 + b % 16
    assert np.array_equal(got, r * span + piece)


@pytest.mark.parametrize("core", STORED)
def test_wgmma_fragment_loads_fall_on_distinct_banks(core):
    """Each of wg_decode's shared-memory loads, over a warp's 32 lanes
    (rows g and g + 8 of the warp's 16, bytes of thread tig), reads
    distinct 4-byte words from distinct banks (lanes on one word share
    it), and stays inside one 16-byte piece: the swizzle keeps the 8 rows
    of a fragment load apart, which the unpadded 64- and 32-byte pitches
    alone would not."""
    rb = F.wg_row_bytes(core)
    steps = F.wg_cols(core) // 16
    lane = np.arange(32)
    g, tig = lane >> 2, lane & 3
    loads = []   # (row offset, byte of the row, bytes) of each load
    for wg in (0, 1):
        for wq in range(4):
            for j in range(F.WG_TPW):
                for h in (0, 8):
                    r = F._TN * (F.WG_TPW * wg + j) + 16 * wq + g + h
                    for s in range(0, steps, 2 if core == "int4c" else 1):
                        if core == "bf16c":
                            for b in (32 * s + 4 * tig, 32 * s + 16 + 4 * tig):
                                loads.append((r, b, 4))
                        else:
                            base = (8 if core == "int4c" else 16) * s \
                                + 2 * tig
                            loads += [(r, base, 2), (r, base + 8, 2)]
    for r, b, size in loads:
        addr = F.wg_swizzle(rb, r, b)
        assert np.array_equal(addr // 16, F.wg_swizzle(rb, r, b + size - 1)
                              // 16)
        words = addr // 4
        unique = np.unique(words)
        assert len(np.unique(unique % 32)) == len(unique), (r, b)
        # Without the swizzle (the rows at their pitch) rows would collide.
        plain = np.unique((r * rb + b) // 4)
        assert len(np.unique(plain % 32)) < len(plain)


@pytest.mark.parametrize("core", STORED)
def test_wgmma_stage_layout_is_aligned(core):
    """A stage: the four corpus boxes (64 rows at the row pitch) from its
    1024-byte aligned base, then k16 steps' hi boxes and lo boxes of
    2048 bytes; each box at a multiple of its swizzle's period (8 rows of
    its span), so the swizzle a load writes is the one wg_swizzle reads;
    the barriers after the last stage, 8-byte aligned."""
    rb, steps = F.wg_row_bytes(core), F.wg_cols(core) // 16
    corpus = [j * F._TN * rb for j in range(F.WG_TILES)]
    query = [F.WG_TILES * F._TN * rb + i * F.WG_BOX for i in range(2 * steps)]
    assert all(o % (8 * rb) == 0 for o in corpus)
    assert all(o % 256 == 0 for o in query)
    assert query[-1] + F.WG_BOX == F.wg_stage_bytes(core)
    for stages in range(2, F.WG_STAGES + 1):
        bars = F.WG_ALIGN + stages * F.wg_stage_bytes(core)
        assert bars % 8 == 0
        assert F.wg_ring_bytes(core, stages) == bars + 2 * F.WG_STAGES * 8


@pytest.mark.parametrize("core", STORED)
def test_wgmma_query_layout_is_core_matrices(core):
    """The query columns of a stage: every (row, column) of every step's
    box at its own offset, a box 64 rows of 32 bytes, each 8-row group
    256 contiguous bytes made of two core matrices (8 rows x 16 bytes) of
    the 32-byte swizzle: a row's 8 columns stay contiguous, the two halves
    of rows 4-7 swapped."""
    steps = F.wg_cols(core) // 16
    st, r, c = np.meshgrid(np.arange(steps), np.arange(64), np.arange(16),
                           indexing="ij")
    off = _query_offset(core, st, r, c)
    assert sorted(off.ravel()) == list(range(0, steps * F.WG_BOX, 2))
    assert (off[..., 1:8] - off[..., :1] == 2 * np.arange(1, 8)).all()
    assert (off[..., 8:] - off[..., 8:9] == 2 * np.arange(8)).all()
    for s in range(steps):
        for rg in range(8):
            block = off[s, 8 * rg:8 * rg + 8]
            assert block.min() == s * F.WG_BOX + 256 * rg
            for half in (0, 1):
                cm = block[:, 8 * half:8 * half + 8] // 16
                assert len(np.unique(cm)) == 8
        swapped = off[s, 4:8, :8] - off[s, 4:8, 8:]
        assert (swapped == 16).all() and (off[s, :4, 8:] - off[s, :4, :8]
                                          == 16).all()


@pytest.mark.parametrize("core", STORED)
def test_wgmma_descriptor_fields_address_the_b_operand(core):
    """Each k16 step's descriptor (start, leading byte offset, stride byte
    offset, layout type 3) addresses query row n, k slot j as the 32-byte
    swizzled K-major layout does: the row's 32 bytes at start + (n / 8)
    SBO + (n % 8) 32, its 16-byte pieces swizzled by bit 7 of that
    offset, which must be column 16 step + j of row n."""
    steps = F.wg_cols(core) // 16
    n, j = np.meshgrid(np.arange(64), np.arange(16), indexing="ij")
    for step in range(steps):
        start, lbo, sbo, layout = _step_descriptor(core, step)
        assert start % 256 == 0 and sbo % 16 == 0 and layout == 3
        assert max(start, lbo, sbo) >> 4 < 1 << 14   # 14-bit fields
        row = (n // 8) * sbo + (n % 8) * 32
        addr = start + _tma_swizzle(32, row + 2 * j)
        assert np.array_equal(addr, _query_offset(core, step, n, j))


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
    slot j is the feature column j of the step's query box holds (the box
    starts at wg_feature's column 16 step and holds 16 consecutive
    features), int4's nibble order across ck-wide chunks included."""
    ck = F.feature_geometry(dim)[0]
    c_ld = F._corpus_width(core, dim)
    row_bytes = c_ld * (2 if core == "bf16c" else 1)
    chunks = -(-row_bytes // F.wg_row_bytes(core))
    seen = set()
    for kc in range(chunks):
        for step in range(F.wg_cols(core) // 16):
            a = _a_slot_features(core, kc, step, ck)
            x = F.wg_feature(core, kc, 16 * step, ck)
            b = [x + j for j in range(16)]
            assert b == [F.wg_feature(core, kc, 16 * step + j, ck)
                         for j in range(16)]
            assert list(a) == b, (kc, step)
            seen.update(b)
    width = 2 * c_ld if core == "int4c" else dim
    assert seen == set(range(width))


@pytest.mark.parametrize("dim", (256, 768, 4200))
def test_wgmma_int4_query_boxes_give_the_product(dim):
    """int4's query in the ring's column order, one box a k16 step from
    wg_feature's first column (zero past dim, as the maps' out-of-bounds
    fill gives), against the nibbles in wg_decode's slot order: a NumPy
    product over the permuted columns equals the product of the unpacked
    codes with the unpermuted query, and the permutation is wg_feature's
    column by column."""
    rng = np.random.default_rng(dim)
    ck = F.feature_geometry(dim)[0]
    codes = rng.integers(-7, 8, (64, dim))
    packed = F.pack_int4(torch.from_numpy(codes), ck).numpy().astype(
        np.uint8)
    q = rng.standard_normal((5, dim)).astype(np.float64)
    c_ld = packed.shape[1]
    chunks = -(-c_ld // F.wg_row_bytes("int4c"))
    cols, vals = [], []
    for kc in range(chunks):
        for step in range(4):
            x = F.wg_feature("int4c", kc, 16 * step, ck)
            box = [x + j for j in range(16)]
            assert box == [F.wg_feature("int4c", kc, 16 * step + j, ck)
                           for j in range(16)]
            cols += box
            for e in range(16):   # A slot e: byte 16 (step // 2) + e
                byte = kc * 32 + 16 * (step // 2) + e
                nib = (packed[:, byte] >> (4 if step % 2 else 0)) & 0xF
                vals.append(np.where(nib >= 8, nib.astype(np.int64) - 16,
                                     nib))
    qp = np.zeros((5, len(cols)))
    live = np.array(cols) < dim
    qp[:, live] = q[:, np.array(cols)[live]]
    got = qp @ np.stack(vals, axis=0)
    want = q @ codes.T
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9)


def test_ab_kernel_a_variants_patch_this_tree():
    """Every variant of ``ab_kernel_a.py`` (``noproducts`` takes the
    tile-64 consumer's products out of ``ring_wgmma.cuh``) patches this
    tree's sources once; ``noproducts`` keeps the fragments consumed and
    leaves no wgmma in wg_issue."""
    import importlib.util
    import re
    from pathlib import Path

    from polars_matmul_tpu_torch.kernels import _build

    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("ab_kernel_a",
                                                  root / "ab_kernel_a.py")
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    assert "noproducts" in ab.VARIANTS
    for name, patches in ab.VARIANTS.items():
        for pattern, replacement, *where in patches:
            path = _build._CSRC / (where[0] if where else "fused_topk.cu")
            src = path.read_text()
            text, hits = re.subn(pattern, replacement, src, count=1)
            assert hits == 1 and text != src, name
            if name == "noproducts":
                issue = text[text.index("__device__ inline void wg_issue"):]
                issue = issue[:issue.index("\n}\n")]
                assert "wgmma_m64n64k16" not in issue
                assert '"r"(x[3])' in issue
