"""Kernel D on one card: a parent checkout's build against this tree's.

Builds the parent's ``polars_matmul_tpu_torch/kernels/csrc/floor.cu``
(with the parent's headers) alone with ``nvcc`` into a library of its own
under ``build/``, loads it with ``ctypes`` beside this tree's library, and
times kernel D at the three experiments' shapes (``tools/exp_floor.py``,
``exp_b256.py``, ``exp_int4.py`` at their JAX sizes, each level, batch and
mode they run, and levels=0 at every shape) in turns: parent, change, each
variant, then the same in reverse, with CUDA events around batches of 8
calls (``tools.median_ms``).  Each side runs at its own geometry: the query
tile by its rule, the splits by its library's occupancy; every side is
called the same way (``call``: the wrapper's allocations, then the C entry).
Beside each entry: whether the change's ``out`` equals the parent's bit for
bit (it does not depend on the splits) and, where both ran the same splits,
every split's levels; the largest decoded difference where they are not
equal; each side's consumer, query tile, splits and blocks an SM; kernel A
(``tools.kernel_a_ms``) on the same operands, and kernel A minus D at
levels=0 for each side.  One JSON line an entry, the card's name and power
limit in each.  Outputs must be bit-equal where the change's consumer is
the mma.sync ring (the parent's bf16x3 staged per tile, with the same
products; its stored cores ran the same ring): the run raises otherwise.

``--variants`` adds builds of this tree's ``floor.cu`` with a line patched
(``VARIANTS``) to the turns.

    mkdir -p build/parent
    git archive <parent> polars_matmul_tpu_torch | tar -x -C build/parent
    python -m polars_matmul_tpu_torch.tools.ab_floor --parent build/parent \\
        --variants shared-stacks
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from ..kernels import _build
from ..kernels import floor as D
from ..kernels import fused_topk as F
from . import card, emit, exp_b256, exp_floor, exp_int4, kernel_a_ms, median_ms

BUILD = Path(__file__).resolve().parents[2] / "build"
EXPERIMENTS = ("exp_floor", "exp_b256", "exp_int4")
# Builds of this tree's floor.cu with a line changed: (pattern,
# replacement) pairs of re.subn, each of which must match once.
VARIANTS = {
    # Every stack in shared memory (no register stacks).
    "shared-stacks": [(r"constexpr int reg_max\([^)]*\) \{\n  return [^;]*;",
                       "constexpr int reg_max(int tm, int core, int "
                       "consumer) {\n  return 0;")],
}


def _nvcc(src: Path, so: Path) -> subprocess.Popen:
    return subprocess.Popen(
        [_build.find_nvcc(), *_build._ARCH, *_build._FLAGS, "-shared", "-I",
         str(src.parent), "-o", str(so), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build(parent: Path, variants=()):
    """(loaded libraries, nvcc's output) by build: the parent's
    ``floor.cu`` and each variant's patched copy of this tree's, every nvcc
    at once, under ``build/``."""
    BUILD.mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="ab-floor-", dir=BUILD))
    srcs = {"parent": parent / "polars_matmul_tpu_torch" / "kernels"
            / "csrc" / "floor.cu"}
    for name in variants:
        d = work / f"src-{name}"
        shutil.copytree(_build._CSRC, d)
        text = (d / "floor.cu").read_text()
        for pattern, replacement in VARIANTS[name]:
            text, hits = re.subn(pattern, replacement, text, count=1)
            if hits != 1:
                raise RuntimeError(f"variant {name}: {pattern} is not in "
                                   f"floor.cu")
        (d / "floor.cu").write_text(text)
        srcs[name] = d / "floor.cu"
    procs = {name: _nvcc(src, work / f"{name}.so")
             for name, src in srcs.items()}
    libs, logs = {}, {}
    for name, proc in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{srcs[name]} failed to build:\n"
                               f"{logs[name]}")
        lib = libs[name] = ctypes.CDLL(str(work / f"{name}.so"))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pmm_floor_stacks.argtypes = [p] * 7 + [i] * 12 + [p]
        lib.pmm_floor_stacks.restype = i
        lib.pmm_floor_blocks_per_sm.argtypes = [i, i, i, i]
        lib.pmm_floor_blocks_per_sm.restype = i
    return libs, logs


def parent_smem(tm: int, core: str, levels: int) -> int:
    """The parent's least shared memory (its ``floor.smem_bytes``): bf16x3's
    per-tile operand tiles or a stored core's ring of two stages, one score
    tile, the stacks in shared memory or the running tile maxima."""
    if core == "bf16x3":
        staging = 2 * (tm + 64) * (32 + 8) * 2
    else:
        staging = F.ring_staging(tm, core, 1, False, 2)[1]
    work = levels * tm * 128 * 4 if levels else tm * 4
    return staging + tm * 65 * 4 + work


def geometry(lib, side: str, m: int, n: int, core: str, levels: int, k: int,
             dim: int):
    """(tm, splits, tiles_per_split, blocks an SM) of one side: the
    parent's query tile by its rule, the others' by this tree's; the
    splits by the side's own occupancy."""
    if side == "parent":
        tm = F.query_tile_rows(m, k)
        while tm > 16 and parent_smem(tm, core, levels) > F.MAX_SMEM:
            tm //= 2
    else:
        tm = D.floor_geometry(m, n, core, levels, k, torch.device("cuda"),
                              dim=dim)[0]
    blocks = lib.pmm_floor_blocks_per_sm(tm, D._CORE_ENUM[core], levels,
                                         D.corpus_width(core, dim))
    if blocks <= 0:
        raise RuntimeError(f"{side}: kernel D cannot run tm={tm} {core} "
                           f"L{levels}: error {blocks}")
    geo = F.launch_geometry(m, n, k, F.device_sms(torch.device("cuda")),
                            blocks, tm)
    return geo + (blocks,)


def call(lib, qp, cp, cb, core: str, levels: int, tn: int, ids: str,
         posu: bool, geo):
    """One side's kernel D at ``geo``, called as ``floor_stacks`` calls
    this tree's: (out, levels or tile maxima)."""
    m, n, dim = qp.shape[0], cp.shape[0], qp.shape[1] // 2
    tm, splits, tps = geo[:3]
    i32 = {"dtype": torch.int32, "device": qp.device}
    done = None
    if levels:
        out = torch.full((m, 128), D.INT32_MIN, **i32)
        lv = torch.empty((m, splits, levels, 128), **i32)
    else:
        out = torch.empty((m, 128), **i32)
        lv = torch.full((m, -(-n // tn)), D.INT32_MIN, **i32)
        done = torch.zeros(-(-m // tm), **i32)
    scale, bias = (None, cb[0]) if core == "bf16x3" else (cb[0], cb[1])
    ptr = F._ptr
    rc = lib.pmm_floor_stacks(
        ptr(qp), ptr(cp), ptr(scale), ptr(bias), ptr(out), ptr(lv),
        ptr(done), m, n, dim, cp.shape[1], D._CORE_ENUM[core], levels, tn,
        D.IDS.index(ids), int(posu), splits, tps, tm,
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise RuntimeError(f"pmm_floor_stacks failed: error {rc}")
    return out, lv


def _decoded_diff(a: torch.Tensor, b: torch.Tensor, levels: int,
                  posu: bool) -> float:
    """The largest difference of the scores two outputs carry (unequal
    packed values only; a packed -inf decodes to NaN)."""
    same = a == b
    if bool(same.all()):
        return 0.0
    if levels == 0:   # sums of truncated maxima
        return float((a.long() - b.long()).abs().max())
    da = D.decode_packed(a, posu).double()
    db = D.decode_packed(b, posu).double()
    return float((da - db)[~same].abs().max())


def entries(dev: torch.device):
    """(experiment, entry, operand builder, core, levels, tn, ids, posu, k)
    of every kernel D launch the three experiments make, and levels=0 at
    each of their shapes; levels None is exp_b256's n_levels (the JAX
    gstack's depth for its corpus), tn None the experiment's."""
    for tag, levels, tn, k in exp_floor.PROGRAMS:
        yield ("exp_floor", tag, ("floor", tn), "bf16x3", levels, tn,
               "global", False, k)
    yield ("exp_floor", "A_k512", ("floor", 4096), "bf16x3", 0, 4096,
           "global", False, 512)
    for levels, posu in ((0, False), (1, False), (None, False), (None, True)):
        yield ("exp_b256", "-posu" if posu else "", ("b256",), "int8c",
               levels, None, "segmented", posu, exp_b256.K)
    for b in exp_int4.BATCHES:
        for tag, core, form in exp_int4.MODES:
            for levels in (0, 1):
                yield ("exp_int4", f"{tag}-b{b} L{levels}",
                       ("int4", form, b), core, levels, None, "tile-local",
                       False, exp_int4.K)


class Operands:
    """The experiments' operands, made once each on the card from their
    seeds (the corpora of one experiment at a time)."""

    def __init__(self, dev: torch.device):
        self.dev, self.key, self.val = dev, None, None

    def get(self, spec):
        kind = spec[0]
        if self.key != kind:
            self.val = None
            torch.cuda.empty_cache()
            if kind == "floor":
                _, cf, qp = exp_floor.build(self.dev)
                self.val = {"cf": cf, "qp": qp, "tn": {}}
            elif kind == "b256":
                q, cp, cb, tn = exp_b256.build(self.dev)
                self.val = {"qp": F.prepare_queries(q, "cosine", "int8c"),
                            "cp": cp, "cb": cb, "tn": tn}
            else:
                q, corpora, tn = exp_int4.build(self.dev)
                self.val = {"q": q, "corpora": corpora, "tn": tn}
            self.key = kind
        v = self.val
        if kind == "floor":
            tn = spec[1]
            if tn not in v["tn"]:
                v["tn"] = {tn: exp_floor.corpus_operands(v["cf"], tn)}
            return (v["qp"], *v["tn"][tn], tn)
        if kind == "b256":
            return v["qp"], v["cp"], v["cb"], v["tn"]
        _, form, b = spec
        qp = F.prepare_queries(v["q"][:b], "cosine", "int8c")
        return (qp, *v["corpora"][form], v["tn"])


def main(parent: Path, experiments=EXPERIMENTS, variants=(), iters: int = 10):
    """Time the parent, this tree and each of ``variants`` in turns at
    every kernel D launch of ``experiments``; returns the records."""
    if not torch.cuda.is_available():
        raise RuntimeError("ab_floor needs a CUDA device")
    dev = torch.device("cuda")
    name = card(dev)
    libs, logs = build(parent, variants)
    libs["change"] = _build.load_library()
    sides = ["parent", "change", *variants]
    ops = Operands(dev)
    results, faults, a_ms = [], [], {}
    for exp, tag, spec, core, levels, tn, ids, posu, k in entries(dev):
        if exp not in experiments:
            continue
        qp, cp, cb, tn_exp = ops.get(spec)
        tn = tn or tn_exp
        if exp == "exp_b256":
            if levels is None:
                levels = D._gstack_geometry(cp.shape[0] // 128, k)[3]
            tag = f"L{levels}{tag}"
        m, n, dim = qp.shape[0], cp.shape[0], qp.shape[1] // 2
        geos = {s: geometry(libs[s], s, m, n, core, levels, k, dim)
                for s in sides}
        fns = {s: (lambda s=s: call(libs[s], qp, cp, cb, core, levels, tn,
                                    ids, posu, geos[s])) for s in sides}
        outs = {s: fns[s]() for s in sides}
        ref_out, ref_lv = outs["parent"]
        consumer = D.floor_consumer(geos["change"][0], core, levels)
        rec = {"card": name, "experiment": exp, "entry": tag,
               "shape": [m, n, dim], "core": core, "levels": levels,
               "tn": tn, "ids": ids, "posu": posu, "k": k,
               "consumer": consumer}
        bits = {}
        for s in sides[1:]:
            out, lv = outs[s]
            same_splits = (geos[s][:3] == geos["parent"][:3]
                           or levels == 0)
            bits[s] = {"out_equal": bool(torch.equal(out, ref_out)),
                       "levels_equal": (bool(torch.equal(lv, ref_lv))
                                        if same_splits else None),
                       "max_diff": _decoded_diff(out, ref_out, levels,
                                                 posu)}
        del outs
        if consumer == "ring" and not (bits["change"]["out_equal"] and
                                       bits["change"]["levels_equal"]
                                       in (True, None)):
            faults.append(f"{exp} {tag}: {bits['change']}")
        times = {s: [] for s in sides}
        for s in sides + sides[::-1]:
            times[s].append(median_ms(fns[s], iters))
        key = (spec, core, k)
        if key not in a_ms:
            a_ms[key] = kernel_a_ms(qp, cp, cb, k, core, iters)
        rec.update({
            "sides": {s: {"ms": times[s], "tm": geos[s][0],
                          "splits": geos[s][1], "blocks_per_sm": geos[s][3]}
                      for s in sides},
            "bits": bits, "kernel_a_ms": a_ms[key]})
        emit(rec)
        results.append(rec)
    # Kernel A minus D at levels 0, and D(L) - D(0), by shape and side.
    zero = {(r["experiment"], str(r["shape"]), r["core"], r["tn"], r["k"]): r
            for r in results if r["levels"] == 0}
    for r in results:
        z = zero.get((r["experiment"], str(r["shape"]), r["core"], r["tn"],
                      r["k"]))
        if z is None or r["levels"] == 0:
            continue
        emit({"card": name, "experiment": r["experiment"],
              "entry": r["entry"], "levels": r["levels"],
              "kernel_a_ms": r["kernel_a_ms"],
              "a_minus_d0_ms": {s: r["kernel_a_ms"] - min(
                  z["sides"][s]["ms"]) for s in sides},
              "dl_minus_d0_ms": {s: min(r["sides"][s]["ms"]) - min(
                  z["sides"][s]["ms"]) for s in sides}})
    for build_name, log in logs.items():
        emit({"card": name, "build": build_name, "ptxas": [
            line.strip() for line in log.splitlines()
            if "registers" in line or "spill" in line]})
    if faults:
        raise RuntimeError("outputs differ from the parent's where the "
                           "consumer is unchanged: " + "; ".join(faults))
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="a checkout of the parent commit (git archive)")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--experiments", default=",".join(EXPERIMENTS),
                    help="comma-separated experiments to time")
    ap.add_argument("--variants", default="",
                    help=f"extra builds, of {', '.join(VARIANTS)}")
    args = ap.parse_args()
    variants = [v for v in args.variants.split(",") if v]
    for v in variants:
        if v not in VARIANTS:
            raise SystemExit(f"ab_floor: unknown variant {v}")
    main(args.parent, experiments=args.experiments.split(","),
         variants=variants, iters=args.iters)
