"""Kernel B's merge order on the CPU (``kernels/csrc/topk_merge.cu``).

A PyTorch model of the kernel's rank merge, written here: sorted (value,
index) lists merge in pairs, entry x of list a landing at x + (entries of
b before it, ``torch.searchsorted`` with side="left" on the order key) and
entry y of b at y + (entries of a before or equal to it, side="right"),
slots past k dropped, an odd list carried up; a block's lists go in passes
of ``cap`` lists with the running result as one more list, and a row's
lists in the groups of ``fused_topk.merge_plan``, then the group lists.
The lists are ``chip_smoke.sorted_lists``, the card's sweep's own.
It must equal ``topk_merge_plain`` (a stable sort of the concatenation)
bit for bit over tie-heavy lists, padded and wholly -inf lists and -inf
entries with real indices, and the JAX package's finish over the same
panel.
"""

import importlib
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polars_matmul_tpu_torch.kernels import fused_topk as F

JF = importlib.import_module("polars_matmul_tpu.kernels.fused_topk")
ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
S = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(S)
MODES = S.MERGE_MODES

torch.set_num_threads(2)

INT32_MAX = np.iinfo(np.int32).max
SPLITS = (1, 2, 3, 31, 32, 33, 258)
KS = (1, 2, 10, 16, 100, 128)
MS = (1, 8, 37)
CAP = 1 << 16   # the CPU grid's m * splits * k


def _key(v, i):
    """An int64 that orders (value desc, index asc) ascending: the value's
    bits made monotone (-0.0 taken as 0.0, as a float compare takes it),
    negated, above the index."""
    bits = (v + 0.0).view(torch.int32).to(torch.int64)
    ordered = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)
    return -ordered * (1 << 32) + i.to(torch.int64)


def _merge_pair(a, b, k):
    """Rank merge of two (rows, k) sorted lists ((v, i, key) each) into
    the first k of their union."""
    (av, ai, ak), (bv, bi, bk) = a, b
    pos = torch.arange(k).expand_as(ak)
    da = pos + torch.searchsorted(bk, ak, side="left")
    db = pos + torch.searchsorted(ak, bk, side="right")
    dest = torch.cat([da, db], dim=1)
    assert torch.equal(torch.sort(dest, dim=1).values,
                       torch.arange(2 * k).expand_as(dest))
    out = []
    for x, y in ((av, bv), (ai, bi), (ak, bk)):
        full = torch.empty_like(torch.cat([x, y], dim=1))
        full.scatter_(1, dest, torch.cat([x, y], dim=1))
        out.append(full[:, :k].contiguous())
    return tuple(out)


def _tree(lists, k):
    """Pairwise rounds down to one list; an odd last list rises as it is."""
    while len(lists) > 1:
        nxt = [_merge_pair(lists[j], lists[j + 1], k)
               for j in range(0, len(lists) - 1, 2)]
        if len(lists) % 2:
            nxt.append(lists[-1])
        lists = nxt
    return lists[0]


def _reduce(lists, k, cap):
    """A block's lists in passes of ``cap``, the running result carried
    into the next pass as list 0."""
    acc, done = None, 0
    while done < len(lists):
        head = [] if acc is None else [acc]
        take = cap - len(head)
        acc = _tree(head + lists[done:done + take], k)
        done += take
    return acc


def rank_merge(part_v, part_i, k, groups=1, cap=1 << 30):
    """The kernel's algorithm on (m, splits, k) lists: (m, k) values and
    int32 indices."""
    splits = part_v.shape[1]
    v = part_v
    i = torch.where(v == float("-inf"), torch.full_like(part_i, INT32_MAX),
                    part_i)
    lists = [(v[:, s].contiguous(), i[:, s].contiguous(),
              _key(v[:, s], i[:, s]).contiguous()) for s in range(splits)]
    per = -(-splits // groups)
    assert (groups - 1) * per < splits, "an empty group"
    firsts = [_reduce(lists[g * per:(g + 1) * per], k, cap)
              for g in range(groups)]
    out_v, out_i, _ = _reduce(firsts, k, cap)
    return out_v.contiguous(), out_i.to(torch.int32).contiguous()


def co_rank(a, b, d, k):
    """The kernel's merge-path split (``co_rank`` in topk_merge.cu): how
    many of the first d merged entries come from list a (a's entry first
    on equal keys), by binary search over order keys."""
    lo, hi = max(0, d - k), min(d, k)
    while lo < hi:
        i = (lo + hi) // 2
        if b[d - i - 1] < a[i]:   # b's entry before a's
            hi = i
        else:
            lo = i + 1
    return lo


def _grid(limit=CAP):
    return [(m, s, k) for m in MS for s in SPLITS for k in KS
            if m * s * k <= limit]


def _lists(m, splits, k, mode, seed):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return S.sorted_lists(torch, gen, m, splits, k, mode, device="cpu")


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("mode", MODES)
def test_rank_merge_equals_the_plain_version(mode, splits):
    cases = 0
    for m, s, k in _grid():
        if s != splits:
            continue
        pv, pi = _lists(m, s, k, mode, seed=m * 7919 + s * 31 + k)
        want_v, want_i = F.topk_merge_plain(pv, pi, k)
        groups, _ = F.merge_plan(m, s, k, 132)
        got_v, got_i = rank_merge(pv, pi, k, groups)
        assert torch.equal(got_v, want_v), (m, s, k)
        assert torch.equal(got_i, want_i), (m, s, k)
        cases += 1
    assert cases >= 6


@pytest.mark.parametrize("groups, cap", [(1, 2), (1, 3), (2, 2), (5, 4),
                                         (7, 3), (16, 5), (33, 1 << 30)])
def test_groups_and_passes_keep_the_result(groups, cap):
    # However the lists split into groups and passes, the merge is the
    # same: the kernel may size both by shared memory and by the batch.
    for mode in ("ties", "empty", "real_inf"):
        for m, s, k in ((3, 33, 10), (2, 258, 16), (1, 40, 128)):
            if (groups - 1) * -(-s // groups) >= s:
                continue   # an empty group: the kernel refuses it
            pv, pi = _lists(m, s, k, mode, seed=groups * 13 + cap)
            got = rank_merge(pv, pi, k, groups, cap)
            want = F.topk_merge_plain(pv, pi, k)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                want[1])


@pytest.mark.parametrize("k", [10, 100])
def test_rank_merge_equals_the_jax_finish(k):
    # The JAX package's finish over the same panel (_chunked_top_k, the
    # step kernel B replaces): the same values; on distinct values the
    # same indices.
    m, s = 8, 33
    pv, pi = _lists(m, s, k, "random", seed=k)
    got_v, got_i = rank_merge(pv, pi, k, F.merge_plan(m, s, k, 132)[0])
    panel = pv.reshape(m, -1).numpy()
    jv, jpos = JF._chunked_top_k(jnp.asarray(panel), k)
    jv, jpos = np.asarray(jv), np.asarray(jpos)
    np.testing.assert_array_equal(got_v.numpy(), jv)
    np.testing.assert_array_equal(
        got_i.numpy(), np.take_along_axis(pi.reshape(m, -1).numpy(), jpos, 1))


def test_the_model_merges_kernel_a_lists():
    # Lists from kernel A's plain version at its launch geometry, tie data
    # and a mask: the model, the wrapper (plain on the CPU) and the plain
    # version of both kernels agree.
    r = np.random.default_rng(3)
    q = torch.from_numpy(r.integers(-2, 3, (7, 16)).astype(np.float32))
    c = torch.from_numpy(r.integers(-2, 3, (900, 16)).astype(np.float32))
    mask = F.pad_mask_row(torch.from_numpy(np.arange(900) % 4 != 0), 900)
    qp = F.prepare_queries(q, "dot", "bf16x3")
    cp, cbp = F.prepare_corpus(c, "dot", precision="bf16x3")
    for k in (1, 10, 100):
        tm, splits, tps = F.launch_geometry(7, 900, k, sm_count=132)
        pv, pi = F.fused_topk_partial(qp, cp, cbp, mask, k, "bf16x3",
                                      splits, tps, tm)
        got = rank_merge(pv, pi, k, F.merge_plan(7, splits, k, 132)[0], 3)
        assert torch.equal(got[0], F.topk_merge(pv, pi, k)[0])
        want = F.fused_topk_plain(qp, cp, cbp, mask, k, "bf16x3")
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("mode", ["ties", "empty", "real_inf"])
def test_merge_path_splits_match_the_ranks(mode):
    # The kernel merges a pair in runs, each from the split co_rank finds:
    # at every diagonal d it must be the number of a's entries whose rank
    # slot lies below d.
    for k in (2, 10, 16, 100):
        v, i = _lists(1, 2, k, mode, seed=k)
        i = torch.where(v == float("-inf"), torch.full_like(i, INT32_MAX), i)
        a, b = (_key(v[0, s], i[0, s]).tolist() for s in (0, 1))
        slots = (torch.arange(k) + torch.searchsorted(
            torch.tensor(b), torch.tensor(a), side="left"))
        for d in range(k + 1):
            assert co_rank(a, b, d, k) == int((slots < d).sum()), (k, d)


def test_cpu_lists_run_the_plain_version_and_count_it():
    pv, pi = _lists(4, 5, 10, "ties", seed=1)
    before = dict(F.launches)
    v, i = F.topk_merge(pv, pi, 10)
    assert F.launches["topk_merge_plain"] == before["topk_merge_plain"] + 1
    assert F.launches["topk_merge"] == before["topk_merge"]
    want = F.topk_merge_plain(pv, pi, 10)
    assert torch.equal(v, want[0]) and torch.equal(i, want[1])


def _bad_arguments():
    v, i = _lists(2, 3, 4, "random", seed=2)
    return {
        "2-d values": (v[0], i[0], 4),
        "shapes differ": (v, i[:, :2].contiguous(), 4),
        "k is not the lists' length": (v, i, 3),
        "f64 values": (v.double(), i, 4),
        "int64 indices": (v, i.long(), 4),
        "not contiguous": (v.transpose(0, 1), i.transpose(0, 1), 4),
    }


@pytest.mark.parametrize("case", list(_bad_arguments()))
def test_argument_errors_still_raise(case):
    with pytest.raises(ValueError, match="topk_merge takes contiguous"):
        F.topk_merge(*_bad_arguments()[case])


@pytest.mark.parametrize("splits, k", [(2, 4097), (F._MAX_SPLITS + 1, 1)])
def test_lists_past_the_kernel_limits_run_plain_on_the_cpu(splits, k):
    # The kernel refuses them on the card (phase 2 of chip_smoke.py); the
    # plain version has no such limit.
    v = torch.zeros((1, splits, k))
    i = torch.arange(splits * k, dtype=torch.int32).reshape(1, splits, k)
    got = F.topk_merge(v, i, k)
    want = F.topk_merge_plain(v, i, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_other_devices_raise():
    v, i = _lists(2, 3, 4, "random", seed=2)
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        F.topk_merge(v.to("meta"), i.to("meta"), 4)


@pytest.mark.parametrize("m", [1, 8, 37, 65, 66, 132, 264, 1000, 5000])
def test_merge_plan_leaves_no_group_empty(m):
    for splits in range(1, F._MAX_SPLITS + 1):
        for k in (1, 2, 10, 100):
            groups, rows = F.merge_plan(m, splits, k, 132)
            assert 1 <= groups <= splits and rows >= 1
            assert groups == 1 or rows == 1
            per = -(-splits // groups)   # the kernel's lists a group
            assert (groups - 1) * per < splits
            if k == 1:
                assert groups == rows == 1
            elif 2 * m >= 132:
                assert groups == 1
            else:
                # The batch's groups stay within two blocks an SM.
                assert m * groups <= 2 * 132 or groups == 1
            if rows > 1:
                # A block's rows share one pass of its shared memory, and
                # the blocks still give every SM two.
                assert rows * splits * k <= F._MERGE_ROW_ENTRIES
                assert -(-m // rows) >= 2 * 132


def test_merge_plan_at_the_main_path_shapes():
    # The batch-8 lists spread over tens of blocks; large batches keep one
    # block a row, or a few rows a block where the rows are small.
    assert F.merge_plan(8, 1024, 100, 132) == (32, 1)
    assert F.merge_plan(8, 264, 100, 132) == (16, 1)
    assert F.merge_plan(8, 258, 100, 132) == (16, 1)
    assert F.merge_plan(1000, 16, 10, 132) == (1, 3)
    assert F.merge_plan(1000, 32, 10, 132) == (1, 3)
    assert F.merge_plan(1000, 16, 100, 132) == (1, 1)
    assert F.merge_plan(1000, 5, 512, 132) == (1, 1)
    assert F.merge_plan(256, 33, 100, 132) == (1, 1)
    assert F.merge_scratch_ints(8, 16, 100) == 8 + 2 * 8 * 16 * 100
    assert F.merge_scratch_ints(5, 2, 3) == 8 + 60


def test_sorted_lists_keep_kernel_a_order():
    for mode in MODES:
        v, i = _lists(3, 5, 7, mode, seed=4)
        assert v.shape == i.shape == (3, 5, 7)
        key = _key(v, torch.where(v == float("-inf"),
                                  torch.full_like(i, INT32_MAX), i))
        assert bool((key[..., 1:] >= key[..., :-1]).all()), mode
        fin = v > float("-inf")
        lo = 14 * torch.arange(5)[None, :, None]
        assert bool(((i >= lo) & (i < lo + 14))[fin].all()), mode


def test_merge_lists_import_no_jax():
    # The card has no jax: chip_smoke.py's lists and kernel B's wrapper
    # must not pull in jax or the JAX package.
    code = ("import sys, torch, chip_smoke; "
            "import polars_matmul_tpu_torch.kernels.fused_topk; "
            "chip_smoke.sorted_lists(torch, torch.Generator(), 2, 3, 4, "
            "'empty', device='cpu'); "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'polars_matmul_tpu' or "
            "m.startswith('polars_matmul_tpu.')]; assert not bad, bad")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert r.returncode == 0, r.stderr
