"""Kernel A on one card: a parent's source against this tree's, built side
by side and timed in turns.

    mkdir -p build/parent
    git archive <parent> polars_matmul_tpu_torch | tar -x -C build/parent
    python ab_kernel_a.py --parent build/parent [--bits-only]
        [--groups canonical,big,...] [--variants noselect,...] [--bucket]
        [--gstack] [--stack]

Run from the checkout's root, beside ``chip_smoke.py``, whose operands,
timer and bounds it reuses, so its cells are that script's.  It builds
kernel A's units (``csrc/fused_topk.cu``, and ``csrc/fused_topk_gstack.cu``
where the tree has it) alone with nvcc, each build into its own library in
a temporary directory under ``build/``: the parent's, this tree's, and
each variant's (this tree's source with a line or two patched, ``VARIANTS``).
Then:

1. ptxas: every ``.cu`` of both trees compiled, each kernel's registers,
   stack and spills keyed by its entry name (the anonymous namespace's
   hash removed); prints the kernels whose lines differ, and every line
   of this tree's kernel A (its out-of-line functions too);
2. bits: each tree's split lists against the parent's at one geometry
   (this tree's), on the canonical operands at every query tile a k can
   take, in the bf16x3 and highest cores, and at each cell's own
   geometry; they must be equal (the variants' too, but "noselect",
   "noproducts", "nodecode" and "nosort", which change what is selected
   or its order);
3. times: kernel A alone (CUDA events, ``chip_smoke.cuda_ms``), each
   build at the geometry its own library's occupancy gives, parent,
   change, variants, then the reverse, beside the bound
   (``chip_smoke._bound``) and a library call, in groups of cells
   (``GROUPS``): ``canonical`` (1000 x 10,000 x 256 f32 at k=10 / 64 / 80
   / 100 / 128 / 129 / 256 / 512 / 1024, bf16x3 and highest: both sides
   of the radix selection's crossover), ``big`` (2M x 256 f32 at batch 8 and
   256, k=10 and 100, and batch 8 at k=512, bf16x3), ``stored`` (the attribution kit's 2M x 768 int8
   operand, ``tools/exp_int4.build``, at batch 256, k=100 and 512),
   ``wide`` (10M x 768 int8, phase 7's corpus, batch 8 at k=100 and 256
   at k=10 and 100), ``wide-int4`` and ``wide-bf16`` (the same corpus
   stored as int4 and bf16, batch 256, k=10 and 100),
   ``clustered`` (phase 8's 10M x 768 int8 clustered corpus, probe 0.05,
   batch 256, k=100) and ``lists`` (phase 8's 2M x 256 f32 clustered
   lists, probe 0.05: 1000 queries at k=10 and 100, and 32 at k=10, the
   listed inserting kernel at query tile 32), and ``bucket`` (the cells of
   the bucket selection, k <= 16: the canonical operands in bf16x3 and
   highest at k=1, 10 and 16, at the query tile the main path takes (64)
   and at 32 and 16; 2M x 256 f32 batch 8 k=10; 10M x 768 int8 batch 8
   k=10; the clustered int8 corpus at probe 0.05 batch 8 k=10 and the 2M x
   256 f32 clustered lists at k=10, 1000 queries and 32; and those lists
   at probe 0.005, fewer than 16 JAX tiles a list, where the JAX
   package's "auto" picks its bucket selection, batch 8 at k=1 and 10),
   and ``gstack`` (the cells of the gstack selection, k <= 128 where it is
   built: the canonical operands in bf16x3 and highest at k=10 at query
   tiles 64, 32 and 16 and at k=100 at 32 and 16; 2M x 256 f32 batch 8 at
   k=10 and 100 and batch 256 at k=10; 10M x 768 int8 batch 8 k=10; the 2M
   x 256 f32 clustered lists at probe 0.05, k=10, 1000 queries and 32),
   and ``gstack-big`` (the gstack selection above k = 128: the canonical
   operands in bf16x3 and highest at k=129, 256, 512 and 1024; 2M x 256
   f32 batch 8 at k=256 and 512, its lossy plans; the 2M x 256 f32
   clustered lists at probe 0.05, 32 queries, k=256).

``--bucket`` adds this tree's build asked for the bucket selection (and
each variant's) as builds of their own, "change+bucket": its lists must
equal the parent's in every cell, and its times sit beside the insertion's
in the same turns; the "bucket..." variants run only so.  ``--gstack``
adds this tree's build asked for the gstack selection, "change+gstack",
the same way: its lists (its exact re-walk's where its detector fired)
must equal the parent's in every cell, and its times sit beside the
insertion's or the slack's in the same turns; it is skipped in a cell
where the gstack is not built.  With a parent that has the gstack
selection (k <= 128), "parent+gstack" runs beside it, and each variant's
build asked for it as "<variant>+gstack".  Above k = 128 the gstack runs
at its own geometry (``fused_topk.gstack_geometry``): its split lists are
held to the parent's radix selection on the same splits, its merged
result to the parent's at the parent's geometry, and kernel A is timed
alone and with kernel B (A + B, this tree's kernel B in a library of its
own), since the splits differ; a cell where it is not built says so.
``--gstack-cap N`` adds this tree's build, and each "gstack..." variant's,
asked for the gstack above k = 128 on splits of at most N tiles
("<build>+gstack@N").  ``--stack`` adds this tree's build asked for the
stack selection (``csrc/fused_topk_stack.cu``; alt 6 of
``pmm_fused_topk_partial``), "change+stack": its lists must equal the
parent's in every cell and lie within tolerance of
``fused_topk.stack_partial_plain``'s, its plan
(``pmm_fused_topk_stack``) the host's, and its times sit beside the
insertion's or the slack's in the same turns, kernel A alone and with
kernel B, with its plain version's time; it is skipped in a cell where it
is not built (dense, query tiles 16 and 32, bf16x3 and highest).  The
``stack`` group (k = 17-128 at query tiles 16 and 32): the canonical
operands in bf16x3 and highest at k=17, 24, 32, 64, 100 and 128; 2M x 256
f32 batch 8 at k=17, 24, 32 and 100, batch 32 at k=17 and 32; planted
data that crowds one column (``chip_smoke._planted_heavy``, 37 x 200,000
x 56) at k=17 and 32.  ``--timed``
names the groups that are timed (the others are held to the parent's bits
only).  A parent older
than the gstack selection, the bucket selection or the carry gate is
called without those arguments (``_Older``); every time here is taken
with the gate off.

Needs a CUDA card, nvcc and the parent checkout; prints one line a result.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
CSRC = Path("polars_matmul_tpu_torch/kernels/csrc")
GROUPS = ("canonical", "big", "stored", "wide", "wide-int4", "wide-bf16",
          "clustered", "lists", "bucket", "gstack", "gstack-big", "stack")
# Builds of this tree's fused_topk.cu with a line or two changed: (pattern,
# replacement) pairs of re.subn, each of which must match once, in
# fused_topk.cu or, given as a third item, another file of csrc/.
VARIANTS = {
    # The tile-64 consumer's products compiled out (wg_issue's wgmma; the
    # fragments are still decoded and consumed, the accumulators stay 0):
    # what the producer, the decode, the epilogue and a selection of equal
    # scores take without the products.
    "noproducts": [(r"wgmma_m64n64k16\(acc1\[j\][^;]*;\s*"
                    r"wgmma_m64n64k16\(acc2\[j\][^;]*;",
                    'asm volatile("" :: "r"(x[0]), "r"(x[1]), "r"(x[2]), '
                    '"r"(x[3]));', "ring_wgmma.cuh")],
    # The tile-64 consumer's decode compiled out (every A fragment the
    # bf16 pair 1.0, 1.0; no stage byte read by a thread): what the
    # producer, the products, the epilogue and a selection of equal scores
    # take without the decode.
    "nodecode": [(r"(__device__ inline void wg_decode\([^{]*\{)",
                  r"\1\n#pragma unroll\n  for (int j = 0; j < kWgTPW; ++j)\n"
                  r"#pragma unroll\n    for (int s = 0; s < wg_steps(CORE); ++s)\n"
                  r"#pragma unroll\n      for (int i = 0; i < 4; ++i) "
                  r"a[j][s][i] = 0x3f803f80u;\n  return;", "ring_wgmma.cuh")],
    # The selection taken out (its share of kernel A): the score tiles are
    # written and nothing selects on them (the radix selection's end then
    # finds its buffers empty).
    "noselect": [(rf"(__device__ inline void {f}\([^{{]*\{{)",
                  r"\1\n  return;")
                 for f in ("select_tile", "append_tile", "radix_tile")],
    # The appending selection at every k (the rule keeps k <= 16 on the
    # insertion and k above kAppendMaxK on the radix selection).
    "append-all": [(r"constexpr int kInsertMaxK = \d+;",
                    "constexpr int kInsertMaxK = 0;"),
                   (r"constexpr int kAppendMaxK = \d+;",
                    "constexpr int kAppendMaxK = 1024;")],
    # The radix selection from k = 64 on, the least k it takes (the rule
    # keeps k <= kAppendMaxK on the slack).
    "radix-all": [(r"constexpr int kAppendMaxK = \d+;",
                   "constexpr int kAppendMaxK = 63;")],
    # The radix selection's final sort taken out (its share; the lists
    # are then unsorted).
    "nosort": [(r"(__device__ __noinline__ void sort_keys\([^{]*\{)",
                r"\1\n  return;")],
    # A slack of at most 64 entries a row.
    "slack64": [(r"constexpr int kSlackMax = \d+;",
                 "constexpr int kSlackMax = 64;")],
    # The carry gate's vote compiled out of the epilogues (its branch on
    # prune and its barrier kept): what the vote costs with the gate off.
    "novote": [(r"(struct CarryGate \{\n  static constexpr bool kGated = )true;",
                r"\1false;")],
    # A slack of k entries a row up to kSlackMax (the first rule measured).
    "slack-k": [(r"return k >= kSlackMax \? kSlackMax : k >= 64 \? 64 : k;",
                 "return k < kSlackMax ? k : kSlackMax;")],
    # The bucket selection built at query tile 64 too, and the f32 walk's
    # at 32 (the mma.sync ring and the f32 walk): its cells' registers
    # beside those walks.
    "bucket64": [(r"return tm <= \(core == kHighest \? 16 : 32\);",
                  "return tm <= 64;")],
    # The bucket selection with an overflow of at most 8 entries a row, or
    # none (a window then ends at a cell's first push).
    "bucket-o8": [(r"constexpr int kBucketOverflow = \d+;",
                   "constexpr int kBucketOverflow = 8;")],
    "bucket-o0": [(r"constexpr int kBucketOverflow = \d+;",
                   "constexpr int kBucketOverflow = 0;")],
    # The JAX kernel's posu (fused_topk.py:291-311) in the gstack selection
    # up to k = 128: its keys' high word the raw bits of the score biased by
    # +1.0 (monotone for the cosine tiers' scores, >= -1), in place of
    # sel_key's orderable transform, taken back by subtracting 1.0 (the
    # bound and the finish).  Not exact ((s + 1) - 1 is not s), so its
    # bits are not checked: timed on the int8c / int4c cosine cells only.
    "posu": [(r"(constexpr uint64_t kEmptyKey = 0x007fffff00000001ull;)",
              r"\1\n__device__ inline uint64_t posu_key(float v, int i) {\n"
              r"  return ((uint64_t)__float_as_uint(v + 1.0f) << 32) |\n"
              r"         (uint32_t)~(2u * (uint32_t)i);\n}\n"
              r"__device__ inline float posu_value(uint64_t key) {\n"
              r"  return __uint_as_float((uint32_t)(key >> 32)) - 1.0f;\n}"),
             (r"put = gstack_put\(key \+ lane, levels, sel_key\(s0",
              "put = gstack_put(key + lane, levels, posu_key(s0"),
             (r"put \|= gstack_put\(key \+ 32 \+ lane, levels,\n(\s*)"
              r"sel_key\(s1", r"put |= gstack_put(key + 32 + lane, levels,"
              r"\n\1posu_key(s1"),
             (r"Cv\[r\] = key_value\(kth\);",
              "Cv[r] = posu_value(kth);"),
             (r"part_v\[o \+ t\] = key_value\(win\);(\n\s*part_i\[o \+ t\]"
              r" = key_index\(win\);)", r"part_v[o + t] = posu_value(win);\1")],
}


def _nvcc(args, src: Path, out: Path) -> subprocess.Popen:
    from polars_matmul_tpu_torch.kernels import _build

    return subprocess.Popen(
        [_build.find_nvcc(), *_build._ARCH, *_build._FLAGS, *args, "-o",
         str(out), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def _plain(name: str) -> str:
    """A mangled name without the anonymous namespace's per-build hash,
    without a kernel A's last template argument where it is false (the
    inserting selection), and a kernel's without its parameters (kernel
    A's carry gate and the tile-64 ring's tensor maps came as
    parameters), so that those kernels key as their parents did."""
    name = re.sub(r"_GLOBAL__N__[0-9a-f]+_|_INTERNAL_[0-9a-f]+_", "", name)
    # nvcc 12's anonymous namespace: <n>_<file>_cu_<8-hex hash of the
    # translation unit>, which differs whenever the source does.
    name = re.sub(r"^(_ZN)\d+_\w*?_cu_[0-9a-f]{8}(?=\d)", r"\1", name)
    name = re.sub(r"(_kernelI\w*?EEE)v\w*$", r"\1", name)
    # The f32 and ring kernels' selection came as a bool (APPEND) before
    # the radix selection made it an int (SEL: 0 insert, 1 append, 2 radix).
    name = re.sub(r"(fused_topk_(?:f32|stored)_kernelI(?:L[ib]\d+E)+?"
                  r"Lb[01]E)Li([01])E(EE)$", r"\1Lb\2E\3", name)
    return re.sub(r"(fused_topk_(?:f32|stored|wgmma)_kernelI(?:L[ib]\d+E)+?"
                  r"Lb[01]E)Lb0E(EE)$", r"\1\2", name)


def _ptxas(log: str, unit: str, out: dict) -> None:
    """Each kernel's "Used N registers" line and its stack / spill line,
    keyed by unit and entry name; an out-of-line function's stack / spill
    line keyed by unit and "function " and its name."""
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = unit + ":" + _plain(m.group(1))
            continue
        f = re.search(r"Function properties for (\w+)", line)
        if f:   # an entry's own, or an out-of-line function's
            if name is None or not name.endswith(":" + _plain(f.group(1))):
                name = unit + ":function " + _plain(f.group(1))
            continue
        m = re.search(r"\d+ bytes stack frame, \d+ bytes spill stores, "
                      r"\d+ bytes spill loads", line)
        if m and name:
            out[name] = m.group(0)
            if ":function " in name:
                name = None
        m = re.search(r"Used \d+ registers", line)
        if m and name:
            out[name] = m.group(0) + "; " + out.get(name, "")
            name = None


def build(parent: Path, work: Path, variants):
    """(libraries by build, ptxas lines by tree): every nvcc at once."""
    trees = {"parent": parent / CSRC, "change": ROOT / CSRC}
    srcs = dict(trees)
    for name in variants:
        d = work / f"src-{name}"
        shutil.copytree(ROOT / CSRC, d)
        for pattern, replacement, *where in VARIANTS[name]:
            path = d / (where[0] if where else "fused_topk.cu")
            text, hits = re.subn(pattern, replacement, path.read_text(),
                                 count=1)
            if hits != 1:
                raise RuntimeError(f"variant {name}: {pattern} is not in "
                                   f"{path.name}")
            path.write_text(text)
        srcs[name] = d
    procs = {}
    for name, d in srcs.items():   # kernel A's units, each on its own
        for cu in _units(d):
            procs[("lib", name, cu.name)] = _nvcc(
                ["-c"], cu, work / f"{name}.{cu.stem}.o")
    for tree, d in trees.items():
        for cu in sorted(d.glob("*.cu")):
            if cu not in _units(d):
                procs[(tree, cu.name, "")] = _nvcc(
                    ["-c"], cu, work / f"{tree}.{cu.stem}.o")
    lines = {name: {} for name in srcs}
    for (kind, name, unit), proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {kind} {name} {unit}:\n"
                               f"{log}")
        if kind == "lib":
            _ptxas(log, STACK_UNIT if unit == STACK_UNIT else "fused_topk.cu",
                   lines[name])
        else:
            _ptxas(log, name, lines[kind])
    from polars_matmul_tpu_torch.kernels import _build

    links = {name: [work / f"{name}.{cu.stem}.o" for cu in _units(d)]
             for name, d in srcs.items()}
    links["merge"] = [work / "change.topk_merge.o"]   # this tree's kernel B
    for name, objs in links.items():
        r = subprocess.run(
            [_build.find_nvcc(), *_build._ARCH, "-shared", "-o",
             str(work / f"{name}.so")] + [str(o) for o in objs],
            capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed linking {name}:\n{r.stdout}"
                               f"{r.stderr}")
    libs = {}
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, d in srcs.items():
        lib = ctypes.CDLL(str(work / f"{name}.so"))
        gated = _takes(d / "fused_topk.cu", "prune")
        gstack = _takes(d / "fused_topk.cu", "flags")
        bucket = gstack or _takes(d / "fused_topk.cu", "bucket")
        lib.pmm_fused_topk_partial.argtypes = (
            [p] * 8 + [i] * (15 if gated else 14) + ([p] if gated else [])
            + ([i, p] if bucket else []) + ([p] if gstack else []) + [p])
        lib.pmm_fused_topk_partial.restype = i
        lib.pmm_fused_topk_blocks_per_sm.argtypes = [i] * 5
        lib.pmm_fused_topk_blocks_per_sm.restype = i
        if (d / STACK_UNIT).exists():
            lib.pmm_fused_topk_stack.argtypes = [i] * 4 + [p]
            lib.pmm_fused_topk_stack.restype = i
        libs[name] = (lib if gated and gstack
                      else _Older(lib, gated, bucket))
    merge = ctypes.CDLL(str(work / "merge.so"))
    merge.pmm_topk_merge.argtypes = [p] * 4 + [i] * 3 + [p]
    merge.pmm_topk_merge.restype = i
    merge.pmm_topk_merge_plan.argtypes = [p] * 5 + [i] * 5 + [p]
    merge.pmm_topk_merge_plan.restype = i
    return libs, lines, merge


# The stack selection's unit.
STACK_UNIT = "fused_topk_stack.cu"


def _units(d: Path):
    """Kernel A's translation units in source directory ``d``:
    fused_topk.cu, and its gstack and stack units where the tree has
    them."""
    return ([d / "fused_topk.cu"] + sorted(d.glob("fused_topk_gstack*.cu"))
            + sorted(d.glob(STACK_UNIT)))


def _takes(src: Path, arg: str) -> bool:
    """Whether the source's ``pmm_fused_topk_partial`` takes ``arg`` (the
    carry gate's "prune", the bucket selection's "bucket", the gstack
    selection's block "flags")."""
    return re.search(rf"int pmm_fused_topk_partial\([^)]*\b{arg}\b",
                     src.read_text()) is not None


class _Older:
    """A library built from a source older than the gstack selection, the
    carry gate or the bucket selection: this tree's wrapper calls
    ``pmm_fused_topk_partial`` with the gate's two arguments, the other
    selection's two (alt: 3 the bucket, 4 the gstack) and the gstack's
    block flags before the stream, and the call goes on without those
    such a build does not take (each off, no counter; the bucket asked
    for as a flag)."""

    def __init__(self, lib, gated: bool, bucket: bool):
        self._lib, self._gated, self._bucket = lib, gated, bucket

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def pmm_fused_topk_partial(self, *args):
        *head, prune, gate_count, alt, alt_count, flags, stream = args
        if not self._gated and (prune or gate_count.value is not None):
            raise RuntimeError("this build has no carry gate")
        if alt == 4 or flags.value is not None:
            raise RuntimeError("this build has no gstack selection")
        if not self._bucket and (alt or alt_count.value is not None):
            raise RuntimeError("this build has no bucket selection")
        return self._lib.pmm_fused_topk_partial(
            *head, *((prune, gate_count) if self._gated else ()),
            *((int(alt == 3), alt_count) if self._bucket else ()), stream)


class Cell:
    """One timed case: prepared operands of a core at k, the f32 (or
    bf16) operands of its library call (None: that call is timed in
    chip_smoke.py), and, listed, (tiles, tn, block_rows)."""

    def __init__(self, label, core, qp, cp, cbp, k, lib_q=None, lib_c=None,
                 listed=None, dim=None, tm=None):
        self.label, self.core, self.k, self.listed = label, core, k, listed
        self.qp, self.cp, self.cbp = qp, cp, cbp
        self.lib_q, self.lib_c, self.dim, self.tm = lib_q, lib_c, dim, tm


def _canonical(cs, F, dev):
    rng = np.random.default_rng(cs.SEED)
    q = torch.from_numpy(rng.standard_normal(
        (cs.N_QUERIES, cs.DIM)).astype(np.float32)).to(dev)
    c = torch.from_numpy(rng.standard_normal(
        (cs.N_CORPUS, cs.DIM)).astype(np.float32)).to(dev)
    qn = q / q.norm(dim=1, keepdim=True)
    cn = c / c.norm(dim=1, keepdim=True)
    cells = []
    for core in ("bf16x3", "highest"):
        cp, cbp = F.prepare_corpus(c, "cosine", precision=core)
        qp = F.prepare_queries(q, "cosine", core)
        cells += [Cell(f"canonical {core} k={k}", core, qp, cp, cbp, k, qn,
                       cn, dim=cs.DIM)
                  for k in (10, 64, 80, 100, 128, 129, 256, 512, 1024)]
    return cells


def _big(cs, F, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    big = torch.randn((cs.BIG_ROWS, cs.DIM), generator=gen, device=dev)
    qbig = {b: torch.randn((b, cs.DIM), generator=gen, device=dev)
            for b in (8, 256)}
    cp, cbp = F.prepare_corpus(big, "cosine", precision="bf16x3")
    cn = big / big.norm(dim=1, keepdim=True)
    del big
    return [Cell(f"2M x 256 f32 batch {b} k={k}", "bf16x3",
                 F.prepare_queries(qbig[b], "cosine", "bf16x3"), cp, cbp, k,
                 qbig[b] / qbig[b].norm(dim=1, keepdim=True), cn, dim=cs.DIM)
            for b, k in ((8, 10), (8, 100), (8, 512), (256, 10), (256, 100))]


def _dequantised(F, cp, cbp, chunk=1 << 20):
    """The cosine rows an int8 core scores, as bf16 (codes times
    1/|codes|), for the library call."""
    out = torch.empty(cp.shape, dtype=torch.bfloat16, device=cp.device)
    for r0 in range(0, cp.shape[0], chunk):
        out[r0:r0 + chunk] = (cp[r0:r0 + chunk].float()
                              * cbp[0, r0:r0 + chunk, None]).to(
                                  torch.bfloat16)
    return out


def _stored(cs, F, dev):
    from polars_matmul_tpu_torch.tools import exp_int4

    q, corpora, _ = exp_int4.build(dev)
    cp, cbp = corpora["int8"]
    del corpora
    qp = F.prepare_queries(q, "cosine", "int8c")
    qn = (q / q.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    rows = _dequantised(F, cp, cbp)
    return [Cell(f"2M x 768 int8 batch 256 k={k}", "int8c", qp, cp, cbp, k,
                 qn, rows, dim=exp_int4.DIM) for k in (100, 512)]


def _wide_tier(cs, F, dev, tier, shapes, library=True):
    """Cells of phase 7's 10M x 768 corpus stored as ``tier`` at (batch,
    k) ``shapes``, with chip_smoke's bf16 library rows (``library``; else
    that call is timed in chip_smoke.py)."""
    import polars_matmul_tpu_torch as pmt

    c = cs._wide_f32(torch)
    corpus = pmt.Corpus(c, storage=tier)
    del c
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED + 1)
    q = torch.randn((256, cs.WIDE_DIM), generator=gen, device=dev)
    cp, cbp = corpus._prepared_for(F.Metric.COSINE)
    rows = cs._library_rows(F, torch, corpus) if library else None
    core = cs.TIER_CORE[tier]
    cells = []
    for b, k in shapes:
        qn = (q[:b] / q[:b].norm(dim=1, keepdim=True)).to(torch.bfloat16)
        cells.append(Cell(f"10M x 768 {tier} batch {b} k={k}", core,
                          F.prepare_queries(q[:b], "cosine", core), cp, cbp,
                          k, qn if library else None, rows, dim=cs.WIDE_DIM))
    return cells


def _wide(cs, F, dev):
    return _wide_tier(cs, F, dev, "int8", ((8, 100), (256, 10), (256, 100)))


def _wide_int4(cs, F, dev):
    return _wide_tier(cs, F, dev, "int4", ((256, 10), (256, 100)))


def _wide_bf16(cs, F, dev):
    return _wide_tier(cs, F, dev, "bf16", ((256, 10), (256, 100)))


def _listed_cell(cs, F, label, cc, q, k, probe=None):
    qr, qp, cp, cbp, core, tiles, br = cs._listed_operands(
        F, cc, q, k, cs.PROBE if probe is None else probe)
    return Cell(label, core, qp, cp, cbp, k,
                listed=(tiles, cc.layout.tn, br), dim=cc.dim)


def _clustered(cs, F, dev):
    import polars_matmul_tpu_torch as pmt

    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    c, queries = cs._blobs(torch, gen, cs.WIDE_ROWS, cs.WIDE_DIM)
    wide = pmt.ClusteredCorpus(c, storage="int8")
    del c
    torch.cuda.empty_cache()
    q = queries(256)
    return [_listed_cell(cs, F, "10M x 768 int8 clustered probe 0.05 batch "
                         "256 k=100", wide, q, 100)]


def _lists(cs, F, dev):
    import polars_matmul_tpu_torch as pmt

    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED + 2)
    c, queries = cs._blobs(torch, gen, cs.BIG_ROWS, cs.DIM)
    proxy = pmt.ClusteredCorpus(c)
    del c
    q = queries(cs.N_QUERIES)
    # Batch 32 at k=10: the bf16x3 core's listed inserting kernel at query
    # tile 32 (chip_smoke.KNOWN_SPILL).
    return [_listed_cell(cs, F, f"2M x 256 f32 clustered probe 0.05 1000 q "
                         f"k={k}", proxy, q, k) for k in (10, 100)] + [
        _listed_cell(cs, F, "2M x 256 f32 clustered probe 0.05 batch 32 "
                     "k=10", proxy, q[:32], 10)]


# The bucket group's probed request of few tiles: a tile count (fewer than
# the 16 JAX tiles a list under which its "auto" picks bucket at k <= 16).
FEW_TILES = 12


def _bucket(cs, F, dev):
    """The bucket selection's cells (k <= 16; see the module's head)."""
    import polars_matmul_tpu_torch as pmt

    cells = []
    rng = np.random.default_rng(cs.SEED)
    q = torch.from_numpy(rng.standard_normal(
        (cs.N_QUERIES, cs.DIM)).astype(np.float32)).to(dev)
    c = torch.from_numpy(rng.standard_normal(
        (cs.N_CORPUS, cs.DIM)).astype(np.float32)).to(dev)
    qn, cn = (x / x.norm(dim=1, keepdim=True) for x in (q, c))
    for core in ("bf16x3", "highest"):
        cp, cbp = F.prepare_corpus(c, "cosine", precision=core)
        qp = F.prepare_queries(q, "cosine", core)
        cells += [Cell(f"canonical {core} k={k} tm {tm or 64}", core, qp, cp,
                       cbp, k, qn, cn, dim=cs.DIM, tm=tm)
                  for k in (1, 10, 16) for tm in (None, 32, 16)]
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    big = torch.randn((cs.BIG_ROWS, cs.DIM), generator=gen, device=dev)
    q8 = torch.randn((8, cs.DIM), generator=gen, device=dev)
    cp, cbp = F.prepare_corpus(big, "cosine", precision="bf16x3")
    cn = big / big.norm(dim=1, keepdim=True)
    cells.append(Cell("2M x 256 f32 batch 8 k=10", "bf16x3",
                      F.prepare_queries(q8, "cosine", "bf16x3"), cp, cbp, 10,
                      q8 / q8.norm(dim=1, keepdim=True), cn, dim=cs.DIM))
    # The highest core at query tile 16, where "auto" takes the bucket.
    cp, cbp = F.prepare_corpus(big, "cosine", precision="highest")
    for b in (8, 16):
        qb = torch.randn((b, cs.DIM), generator=gen, device=dev)
        qp = F.prepare_queries(qb, "cosine", "highest")
        cells += [Cell(f"2M x 256 f32 highest batch {b} k={k}", "highest",
                       qp, cp, cbp, k, qb / qb.norm(dim=1, keepdim=True), cn,
                       dim=cs.DIM) for k in (1, 10, 16)]
    del big
    # The clustered corpus first: its build holds the f32 source and a
    # permuted copy beside what the cells keep.
    gen.manual_seed(cs.SEED)
    c, queries = cs._blobs(torch, gen, cs.WIDE_ROWS, cs.WIDE_DIM)
    wide = pmt.ClusteredCorpus(c, storage="int8")
    del c
    torch.cuda.empty_cache()
    cells.append(_listed_cell(cs, F, "10M x 768 int8 clustered probe 0.05 "
                              "batch 8 k=10", wide, queries(8), 10))
    del wide
    torch.cuda.empty_cache()
    cells += _wide_tier(cs, F, dev, "int8", ((8, 10),), library=False)
    gen.manual_seed(cs.SEED + 2)
    c, queries = cs._blobs(torch, gen, cs.BIG_ROWS, cs.DIM)
    proxy = pmt.ClusteredCorpus(c)
    del c
    q = queries(cs.N_QUERIES)
    cells += [_listed_cell(cs, F, f"2M x 256 f32 clustered probe 0.05 "
                           f"{m} q k=10", proxy, q[:m], 10)
              for m in (cs.N_QUERIES, 32)]
    cells += [_listed_cell(cs, F, f"2M x 256 f32 clustered probe "
                           f"{FEW_TILES} tiles batch 8 k={k}", proxy, q[:8],
                           k, FEW_TILES) for k in (1, 10)]
    return cells


def _gstack(cs, F, dev):
    """The gstack selection's cells (k <= 128; see the module's head)."""
    import polars_matmul_tpu_torch as pmt

    cells = []
    rng = np.random.default_rng(cs.SEED)
    q = torch.from_numpy(rng.standard_normal(
        (cs.N_QUERIES, cs.DIM)).astype(np.float32)).to(dev)
    c = torch.from_numpy(rng.standard_normal(
        (cs.N_CORPUS, cs.DIM)).astype(np.float32)).to(dev)
    qn, cn = (x / x.norm(dim=1, keepdim=True) for x in (q, c))
    for core in ("bf16x3", "highest"):
        cp, cbp = F.prepare_corpus(c, "cosine", precision=core)
        qp = F.prepare_queries(q, "cosine", core)
        cells += [Cell(f"canonical {core} k={k} tm {tm or 64}", core, qp, cp,
                       cbp, k, qn, cn, dim=cs.DIM, tm=tm)
                  for k, tms in ((10, (None, 32, 16)), (100, (32, 16)))
                  for tm in tms]
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    big = torch.randn((cs.BIG_ROWS, cs.DIM), generator=gen, device=dev)
    cp, cbp = F.prepare_corpus(big, "cosine", precision="bf16x3")
    cn = big / big.norm(dim=1, keepdim=True)
    for b, k in ((8, 10), (8, 100), (256, 10)):
        qb = torch.randn((b, cs.DIM), generator=gen, device=dev)
        cells.append(Cell(f"2M x 256 f32 batch {b} k={k}", "bf16x3",
                          F.prepare_queries(qb, "cosine", "bf16x3"), cp, cbp,
                          k, qb / qb.norm(dim=1, keepdim=True), cn,
                          dim=cs.DIM))
    del big
    torch.cuda.empty_cache()
    cells += _wide_tier(cs, F, dev, "int8", ((8, 10),), library=False)
    gen.manual_seed(cs.SEED + 2)
    c, queries = cs._blobs(torch, gen, cs.BIG_ROWS, cs.DIM)
    proxy = pmt.ClusteredCorpus(c)
    del c
    q = queries(cs.N_QUERIES)
    cells += [_listed_cell(cs, F, f"2M x 256 f32 clustered probe 0.05 "
                           f"{m} q k=10", proxy, q[:m], 10)
              for m in (cs.N_QUERIES, 32)]
    return cells


def _gstack_big(cs, F, dev):
    """The gstack selection's cells above k = 128 (see the module's
    head)."""
    import polars_matmul_tpu_torch as pmt

    cells = []
    rng = np.random.default_rng(cs.SEED)
    q = torch.from_numpy(rng.standard_normal(
        (cs.N_QUERIES, cs.DIM)).astype(np.float32)).to(dev)
    c = torch.from_numpy(rng.standard_normal(
        (cs.N_CORPUS, cs.DIM)).astype(np.float32)).to(dev)
    qn, cn = (x / x.norm(dim=1, keepdim=True) for x in (q, c))
    for core in ("bf16x3", "highest"):
        cp, cbp = F.prepare_corpus(c, "cosine", precision=core)
        qp = F.prepare_queries(q, "cosine", core)
        cells += [Cell(f"canonical {core} k={k}", core, qp, cp, cbp, k, qn,
                       cn, dim=cs.DIM) for k in (129, 256, 512, 1024)]
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    big = torch.randn((cs.BIG_ROWS, cs.DIM), generator=gen, device=dev)
    cp, cbp = F.prepare_corpus(big, "cosine", precision="bf16x3")
    cn = big / big.norm(dim=1, keepdim=True)
    qb = torch.randn((8, cs.DIM), generator=gen, device=dev)
    cells += [Cell(f"2M x 256 f32 batch 8 k={k}", "bf16x3",
                   F.prepare_queries(qb, "cosine", "bf16x3"), cp, cbp, k,
                   qb / qb.norm(dim=1, keepdim=True), cn, dim=cs.DIM)
              for k in (256, 512)]
    del big
    torch.cuda.empty_cache()
    gen.manual_seed(cs.SEED + 2)
    c, queries = cs._blobs(torch, gen, cs.BIG_ROWS, cs.DIM)
    proxy = pmt.ClusteredCorpus(c)
    del c
    q = queries(cs.N_QUERIES)
    cells.append(_listed_cell(cs, F, "2M x 256 f32 clustered probe 0.05 32 "
                              "q k=256", proxy, q[:32], 256))
    return cells


# The stack group's canonical k: its class (17-32) and above.
STACK_KS = (17, 24, 32, 64, 100, 128)


def _stack(cs, F, dev):
    """The stack selection's cells (see the module's head)."""
    cells = []
    rng = np.random.default_rng(cs.SEED)
    q = torch.from_numpy(rng.standard_normal(
        (cs.N_QUERIES, cs.DIM)).astype(np.float32)).to(dev)
    c = torch.from_numpy(rng.standard_normal(
        (cs.N_CORPUS, cs.DIM)).astype(np.float32)).to(dev)
    qn, cn = (x / x.norm(dim=1, keepdim=True) for x in (q, c))
    for core in ("bf16x3", "highest"):
        cp, cbp = F.prepare_corpus(c, "cosine", precision=core)
        qp = F.prepare_queries(q, "cosine", core)
        cells += [Cell(f"canonical {core} k={k} tm {tm}", core, qp, cp,
                       cbp, k, qn, cn, dim=cs.DIM, tm=tm)
                  for k in STACK_KS for tm in (16, 32)]
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    big = torch.randn((cs.BIG_ROWS, cs.DIM), generator=gen, device=dev)
    cp, cbp = F.prepare_corpus(big, "cosine", precision="bf16x3")
    cn = big / big.norm(dim=1, keepdim=True)
    for b, ks in ((8, (17, 24, 32, 100)), (32, (17, 32))):
        qb = torch.randn((b, cs.DIM), generator=gen, device=dev)
        cells += [Cell(f"2M x 256 f32 batch {b} k={k}", "bf16x3",
                       F.prepare_queries(qb, "cosine", "bf16x3"), cp, cbp, k,
                       qb / qb.norm(dim=1, keepdim=True), cn, dim=cs.DIM)
                  for k in ks]
    del big, cn
    torch.cuda.empty_cache()
    # Planted data that crowds one column of the tile with every row's
    # winners (chip_smoke._planted_heavy), over splits of about 36 tiles:
    # a cell holds a window's whole column, so the lists stay exact.
    gen.manual_seed(cs.SEED + 3)
    q, c = cs._planted_heavy(torch, gen, 37, 200_000, 56)
    cp, cbp = F.prepare_corpus(c, "dot", precision="bf16x3")
    cells += [Cell(f"planted 37 x 200,000 x 56 dot k={k} tm 16", "bf16x3",
                   F.prepare_queries(q, "dot", "bf16x3"), cp, cbp, k, dim=56,
                   tm=16) for k in (17, 32)]
    return cells


BUILDERS = {"canonical": _canonical, "big": _big, "stored": _stored,
            "wide": _wide, "wide-int4": _wide_int4, "wide-bf16": _wide_bf16,
            "clustered": _clustered, "lists": _lists, "bucket": _bucket,
            "gstack": _gstack, "gstack-big": _gstack_big, "stack": _stack}


def _verdict(card, label, name, times, lib):
    """Route ``name`` (a build asked for the bucket or the gstack
    selection) against the insertion or slack of build ``lib`` (this
    tree's for the "bucket..." variants, whose insertion is its code):
    each one's median over its turns, the spread (the larger of the two
    routes' max - min), and whether the asked-for selection is faster
    beyond it."""
    ins = [ms for ms, _ in times[lib]]
    got = [ms for ms, _ in times[name]]
    spread = max(max(ins) - min(ins), max(got) - min(got))
    a, b = statistics.median(ins), statistics.median(got)
    print(f"[{card}] {label}: {name} against {lib}: medians {b:.4f} / "
          f"{a:.4f} ms ({(b - a) / a:+.1%}), spread {spread:.4f}; "
          f"{name.split('+')[-1]} "
          f"{'faster' if a - b > spread else 'not faster'} beyond the spread")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="a checkout of the parent (git archive)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--bits-only", action="store_true",
                    help="ptxas and bits, no times")
    ap.add_argument("--groups", default=",".join(GROUPS),
                    help=f"cells to run, of {', '.join(GROUPS)}")
    ap.add_argument("--variants", default="",
                    help=f"extra builds, of {', '.join(VARIANTS)}")
    ap.add_argument("--bucket", action="store_true",
                    help="also this tree (and each variant) asked for the "
                         "bucket selection")
    ap.add_argument("--gstack", action="store_true",
                    help="also this tree asked for the gstack selection")
    ap.add_argument("--stack", action="store_true",
                    help="also this tree asked for the stack selection")
    ap.add_argument("--gstack-cap", default="",
                    help="with --gstack, also each build asked for it above "
                         "k = 128 on splits no longer than N tiles "
                         "(\"<build>+gstack@N\")")
    ap.add_argument("--timed", default=None,
                    help="the groups to time (default: every group run)")
    ap.add_argument("--rounds", type=int, default=1,
                    help="rounds of turns (each: every build, then in "
                         "reverse)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ab_kernel_a: no CUDA device", file=sys.stderr)
        return 2
    groups = [g for g in args.groups.split(",") if g]
    timed = groups if args.timed is None else args.timed.split(",")
    variants = [v for v in args.variants.split(",") if v]
    for name in groups + variants:
        if name not in GROUPS and name not in VARIANTS:
            raise SystemExit(f"ab_kernel_a: unknown group or variant {name}")
    import chip_smoke as cs
    from polars_matmul_tpu_torch.kernels import _build
    from polars_matmul_tpu_torch.kernels import fused_topk as F
    from polars_matmul_tpu_torch.ops.reference import exact_matmul

    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="ab-", dir=ROOT / "build"))
    libs, lines, merge_lib = build(args.parent.resolve(), work, variants)
    card = cs.phase_card()
    same = [k for k in lines["parent"] if lines["change"].get(k)
            == lines["parent"][k]]
    print(f"ptxas: {len(same)} kernels with equal lines in the parent and "
          f"this tree")
    for key in sorted(set(lines["parent"]) | set(lines["change"])):
        if lines["parent"].get(key) != lines["change"].get(key):
            print(f"ptxas differs: {key}\n  parent: "
                  f"{lines['parent'].get(key)}\n  change: "
                  f"{lines['change'].get(key)}")
    for key in sorted(lines["change"]):
        if key.startswith("fused_topk.cu:"):
            print(f"ptxas change: {key}: {lines['change'][key]}")
    stack = {key: line for key, line in lines["change"].items()
             if key.startswith(STACK_UNIT + ":")}
    if stack:
        spills = [key for key, line in stack.items()
                  if not line.endswith(" 0 bytes spill loads")]
        print(f"ptxas stack: {len(stack)} instantiations, {len(spills)} "
              f"spilling")
        for key in sorted(stack):
            print(f"ptxas stack: {key}: {stack[key]}")
    for name in variants:
        spills = [key for key, line in lines[name].items()
                  if key.startswith("fused_topk.cu:")
                  and not line.endswith(" 0 bytes spill loads")]
        print(f"ptxas {name}: kernel A spills in {len(spills)} "
              f"instantiations: " + "; ".join(
                  f"{key}: {lines[name][key]}" for key in sorted(spills)))
        for key in sorted(set(lines[name]) - set(lines["change"])):
            print(f"ptxas {name} only: {key}: {lines[name][key]}")

    # The builds timed: each library, and with --bucket this tree's and
    # the variants' asked for the bucket selection ("<name>+bucket"), with
    # --gstack this tree's asked for the gstack selection
    # ("change+gstack").
    routes = {name: (name, None) for name in libs
              if not name.startswith("bucket")}
    if args.bucket:
        routes.update({f"{name}+bucket": (name, "bucket") for name in libs
                       if name != "parent"})
    if args.gstack:
        routes["change+gstack"] = ("change", "gstack")
        if _takes(args.parent.resolve() / CSRC / "fused_topk.cu", "flags"):
            routes["parent+gstack"] = ("parent", "gstack")
        routes.update({f"{name}+gstack": (name, "gstack")
                       for name in variants})
        if args.gstack_cap:
            routes.update({f"{name}+gstack@{args.gstack_cap}":
                           (name, "gstack") for name in ["change"] + [
                               v for v in variants if v.startswith("gstack")]})

    if args.stack:
        routes["change+stack"] = ("change", "stack")

    def use(name):
        _build._lib = libs[routes[name][0]]
        F._occupancy.clear()

    dev = torch.device("cuda")
    sms = F.device_sms(dev)

    def geometry(cell, tm=None):
        m = cell.qp.shape[0]
        if cell.listed is None:
            return F.kernel_geometry(m, cell.cp.shape[0], cell.k, cell.core,
                                     dev, tm, dim=cell.dim)
        tiles, tn, br = cell.listed
        tm = tm or F.listed_tile_rows(m, cell.k, br)
        return F.kernel_geometry(m, tiles.shape[1] * tn, cell.k, cell.core,
                                 dev, tm, listed=True, dim=cell.dim)

    def route_geometry(cell, name):
        """The geometry of route ``name``: the gstack's own above k = 128
        (this tree's ``gstack_geometry``; None where it is not built), else
        ``geometry``."""
        if routes[name][1] != "gstack" or cell.k <= F.APPEND_MAX_K:
            return geometry(cell, cell.tm)
        m, rows = cell.qp.shape[0], cell.cp.shape[0]
        if cell.listed is not None:
            rows = cell.listed[0].shape[1] * cell.listed[1]
        if "@" not in name:
            return F.gstack_geometry(m, rows, cell.k, cell.core, sms)
        # Splits of at most the cap's tiles (the lossless depth capped).
        deepest, cap = F.gstack_deepest, int(name.split("@")[1])
        F.gstack_deepest = lambda core, k: min(deepest(core, k), cap)
        try:
            return F.gstack_geometry(m, rows, cell.k, cell.core, sms)
        finally:
            F.gstack_deepest = deepest

    def merge(lists, k):
        """Kernel B (this tree's, from its own library) on a route's
        lists."""
        lib, _build._lib = _build._lib, merge_lib
        try:
            return F.topk_merge(*lists, k)
        finally:
            _build._lib = lib

    def launch(cell, geo, name="change"):
        tm, splits, tps = geo
        extra = () if cell.listed is None else cell.listed
        return F.fused_topk_partial(cell.qp, cell.cp, cell.cbp, None, cell.k,
                                    cell.core, splits, tps, tm, *extra,
                                    bucket=routes[name][1] == "bucket",
                                    gstack=routes[name][1] == "gstack",
                                    stack=routes[name][1] == "stack")

    def built(cell, geo, name):
        """Whether ``name`` runs its own route at this cell: a build asked
        for the gstack or the stack selection only where it is built."""
        if routes[name][1] == "stack":
            return (cell.listed is None
                    and F.stack_built(geo[0], cell.core, cell.k))
        if routes[name][1] != "gstack":
            return True
        if cell.k > F.APPEND_MAX_K and routes[name][0] == "parent":
            return False   # the parent's gstack stops at k = 128
        return F.gstack_built(geo[0], cell.core, cell.k, geo[2])

    def stack_check(label, cell, geo, name, got):
        """The stack's plan against the host's, its lists ``got`` against
        its plain version's."""
        tm, splits, tps = geo
        out = (ctypes.c_int * 3)()
        built = _build._lib.pmm_fused_topk_stack(
            tm, F.CORES.index(cell.core), cell.k, cell.cp.shape[1], out)
        want = (int(F.stack_built(tm, cell.core, cell.k)), F.STACK_WINDOW)
        # Real data: the plain version's scores round otherwise than the
        # ring's, so the lists are held within chip_smoke's tolerance of
        # the row's term scale (``compare`` raises where they are not).
        scale = cs._term_scale(F, cell.qp, cell.cp, cell.cbp, cell.core)
        err = cs.compare(*got, *F.stack_partial_plain(
            cell.qp, cell.cp, cell.cbp, None, cell.k, cell.core, splits,
            tps), scale=scale[:, :, None],
            what=f"{label}: {name} against stack_partial_plain")
        print(f"stack: {label} (tm={tm}, splits={splits}): {name} built "
              f"{built}, window {out[0]}, {out[1]} bytes beside the ring's "
              f"least plan, {out[2]} stages; lists within tolerance of "
              f"stack_partial_plain's: True (max abs err {err:.3g})")
        if (built, out[0]) != want:
            raise RuntimeError(f"{label}: {name}'s plan {built, out[0]} is "
                               f"not the host's {want}")

    def bits(label, cell, geo):
        outs = {}
        for name, (lib_name, sel) in routes.items():
            if lib_name not in ("noselect", "noproducts", "nodecode",
                                "nosort", "posu") and built(cell, geo, name):
                use(name)
                outs[name] = launch(cell, geo, name)
                if sel == "stack":
                    stack_check(label, cell, geo, name, outs[name])
        torch.cuda.synchronize()
        pv, pi = outs.pop("parent")
        for name, (v, i) in outs.items():
            equal = torch.equal(v, pv) and torch.equal(i, pi)
            print(f"bits: {label} (tm={geo[0]}, splits={geo[1]}): {name} "
                  f"against the parent: equal {equal}")
            if not equal:
                raise RuntimeError(f"{label}: {name}'s split lists differ "
                                   f"from the parent's")

    order = (list(routes) + list(reversed(list(routes)))) * args.rounds
    for group in groups:
        cells = BUILDERS[group](cs, F, dev)
        torch.cuda.synchronize()
        use("change")
        if group == "canonical":
            # Every query tile each k can take.
            for cell in cells:
                for tm in (16, 32, 64):
                    if F.query_tile_rows(1000, cell.k) >= tm:
                        bits(f"{cell.label} at tm {tm}", cell,
                             F.launch_geometry(cs.N_QUERIES, cs.N_CORPUS,
                                               cell.k, sms, 2, tm))
        use("change")
        for cell in cells:
            bits(cell.label, cell, geometry(cell, cell.tm))
            if args.gstack and cell.k > F.APPEND_MAX_K:
                # The gstack's own splits: its lists against the radix
                # selection's on them, and its merged result against the
                # parent's at the parent's own geometry.
                geo = route_geometry(cell, "change+gstack")
                if geo is None:
                    print(f"bits: {cell.label}: the gstack is not built "
                          f"(selection='gstack' runs the radix)")
                    continue
                bits(f"{cell.label} at the gstack's geometry", cell, geo)
                use("parent")
                want = merge(launch(cell, geometry(cell, cell.tm), "parent"),
                             cell.k)
                use("change+gstack")
                got = merge(launch(cell, geo, "change+gstack"), cell.k)
                equal = torch.equal(got[0], want[0]) and torch.equal(
                    got[1], want[1])
                print(f"bits: {cell.label}: change+gstack merged (tm="
                      f"{geo[0]}, splits={geo[1]}) against the parent's at "
                      f"its own geometry: equal {equal}")
                if not equal:
                    raise RuntimeError(f"{cell.label}: the gstack's merged "
                                       f"result differs from the parent's")
        if args.bits_only or group not in timed:
            continue
        for cell in cells:
            times, merged = {}, {}
            for name in order:
                use(name)
                geo = route_geometry(cell, name)
                if geo is None or not built(cell, geo, name):
                    continue
                ms = cs.cuda_ms(lambda: launch(cell, geo, name),
                                reps=args.reps)
                times.setdefault(name, []).append((ms, geo))
                if cell.k > F.APPEND_MAX_K or group == "stack":   # A + B
                    ms = cs.cuda_ms(lambda: merge(launch(cell, geo, name),
                                                  cell.k), reps=args.reps)
                    merged.setdefault(name, []).append((ms, geo))
            use("change")
            m, k = cell.qp.shape[0], cell.k
            if cell.listed is None:
                lists, rows = 1, cell.cp.shape[0]
            else:
                lists = cell.listed[0].shape[0]
                rows = cell.listed[0].shape[1] * cell.listed[1]
            splits = times["change"][0][1][1]
            row_bytes = cell.cp.shape[1] * cell.cp.element_size() + 4 * (
                cell.cbp.shape[0] if cell.cbp.ndim == 2 else 1)
            passes, peak = ((1, "float32_cuda_cores")
                            if cell.core == "highest" else
                            (3 if cell.core == "bf16x3" else 2, "bfloat16"))
            bound = cs._bound(lists * rows * row_bytes + cell.qp.nbytes
                              + m * splits * k * 8,
                              passes * 2 * m * rows * cell.dim, peak)
            if cell.lib_q is not None:
                zero = torch.zeros(cell.lib_c.shape[0], device="cuda",
                                   dtype=cell.lib_c.dtype)

                def library():
                    with exact_matmul():
                        return torch.topk(torch.addmm(zero, cell.lib_q,
                                                      cell.lib_c.T), k, dim=1)

                lib = (f"{cs.cuda_ms(library, reps=10):.4f} ms "
                       f"({str(cell.lib_c.dtype).split('.')[-1]} rows)")
            else:
                lib = "in chip_smoke.py phase 6"
            if group == "stack":
                # The stack's plain version at the own selection's
                # geometry.
                _, splits, tps = times["change"][0][1]
                ms = cs.cuda_ms(lambda: F.stack_partial_plain(
                    cell.qp, cell.cp, cell.cbp, None, k, cell.core, splits,
                    tps), reps=2, warmup=1)
                print(f"[{card}] {cell.label}: plain stack_partial_plain "
                      f"{ms:.3f} ms")
            print(f"[{card}] {cell.label}: " + "; ".join(
                f"{name} {' / '.join(f'{ms:.4f}' for ms, _ in ts)} ms (tm "
                f"{ts[0][1][0]}, splits {ts[0][1][1]})"
                for name, ts in times.items())
                + f" | bound {bound[0]:.4f} ms ({bound[1]}) | torch.addmm + "
                f"torch.topk {lib}")
            if merged:
                print(f"[{card}] {cell.label}: A + B: " + "; ".join(
                    f"{name} {' / '.join(f'{ms:.4f}' for ms, _ in ts)} ms "
                    f"(tm {ts[0][1][0]}, splits {ts[0][1][1]})"
                    for name, ts in merged.items()))
            for name in routes:
                if ("+bucket" in name or "+gstack" in name
                        or "+stack" in name) and name in times:
                    lib_name = routes[name][0]
                    _verdict(card, cell.label, name, times,
                             lib_name if lib_name in times else "change")
                    if name in merged:
                        _verdict(card, cell.label + " (A + B)", name, merged,
                                 lib_name if lib_name in merged
                                 else "change")
            if "parent+gstack" in times and "change+gstack" in times:
                _verdict(card, cell.label, "change+gstack", times,
                         "parent+gstack")
        del cells
        torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    print("ab_kernel_a: done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
