"""Kernel A's bf16x3 core on one card: a parent's source against this
tree's, built side by side and timed in turns.

    mkdir -p build/parent
    git archive <parent> polars_matmul_tpu_torch | tar -x -C build/parent
    python ab_kernel_a.py --parent build/parent

Run from the checkout's root, beside ``chip_smoke.py``, whose operands,
timer and bounds it reuses, so its cells are that script's.  It builds
``csrc/fused_topk.cu`` alone with nvcc twice, each into its own library
in a temporary directory under ``build/``: the parent's and this tree's.
Then:

1. ptxas: every ``.cu`` of both trees compiled, each kernel's registers,
   stack and spills keyed by its entry name (the anonymous namespace's
   hash removed); prints the kernels whose lines differ;
2. bits: this tree's split lists against the parent's at one geometry
   (this tree's), at query tiles 16, 32 and 64 on the canonical operands
   and at the cells' own tiles; they must be equal (both run mma.sync);
3. times: kernel A alone (CUDA events, ``chip_smoke.cuda_ms``), each
   tree at the geometry its own library's occupancy gives, parent,
   change, change, parent, at the canonical k=10 / 100 / 512, the
   2M x 256 f32 corpus at batch 8 and 256 (k=10), and the 2M x 256 f32
   clustered corpus's tile lists (1000 queries, probe 0.05, k=10), beside
   the bound (``chip_smoke._bound``) and ``torch.addmm`` + ``torch.topk``
   in f32.

Needs a CUDA card, nvcc and the parent checkout; prints one line a result.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
CSRC = Path("polars_matmul_tpu_torch/kernels/csrc")


def _nvcc(args, src: Path, out: Path) -> subprocess.Popen:
    from polars_matmul_tpu_torch.kernels import _build

    return subprocess.Popen(
        [_build.find_nvcc(), *_build._ARCH, *_build._FLAGS, *args, "-o",
         str(out), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def _ptxas(log: str, unit: str, out: dict) -> None:
    """Each kernel's "Used N registers" line and its stack / spill line,
    keyed by unit and entry name."""
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = unit + ":" + re.sub(r"_GLOBAL__N__[0-9a-f]+_", "",
                                       m.group(1))
            continue
        m = re.search(r"\d+ bytes stack frame, \d+ bytes spill stores, "
                      r"\d+ bytes spill loads", line)
        if m and name:
            out[name] = m.group(0)
        m = re.search(r"Used \d+ registers", line)
        if m and name:
            out[name] = m.group(0) + "; " + out.get(name, "")
            name = None


def build(parent: Path, work: Path):
    """(libraries by variant, ptxas lines by tree): every nvcc at once."""
    trees = {"parent": parent / CSRC, "change": ROOT / CSRC}
    procs = {}
    for name, d in trees.items():
        procs[("lib", name)] = _nvcc(["-shared"], d / "fused_topk.cu",
                                     work / f"{name}.so")
    for tree, d in trees.items():
        for cu in sorted(d.glob("*.cu")):
            if cu.name != "fused_topk.cu":
                procs[(tree, cu.name)] = _nvcc(
                    ["-c"], cu, work / f"{tree}.{cu.stem}.o")
    lines = {name: {} for name in trees}
    for (kind, name), proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {kind} {name}:\n{log}")
        if kind == "lib":
            _ptxas(log, "fused_topk.cu", lines[name])
        else:
            _ptxas(log, name, lines[kind])
    libs = {}
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in trees:
        lib = ctypes.CDLL(str(work / f"{name}.so"))
        lib.pmm_fused_topk_partial.argtypes = [p] * 8 + [i] * 14 + [p]
        lib.pmm_fused_topk_partial.restype = i
        lib.pmm_fused_topk_blocks_per_sm.argtypes = [i] * 5
        lib.pmm_fused_topk_blocks_per_sm.restype = i
        libs[name] = lib
    return libs, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="a checkout of the parent (git archive)")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ab_kernel_a: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import polars_matmul_tpu_torch as pmt
    from polars_matmul_tpu_torch.kernels import _build
    from polars_matmul_tpu_torch.kernels import fused_topk as F
    from polars_matmul_tpu_torch.ops.reference import exact_matmul

    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="ab-", dir=ROOT / "build"))
    libs, lines = build(args.parent.resolve(), work)
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

    def use(name):
        _build._lib = libs[name]
        F._occupancy.clear()

    dev = torch.device("cuda")
    sms = F.device_sms(dev)
    rng = np.random.default_rng(cs.SEED)
    q = torch.from_numpy(rng.standard_normal(
        (cs.N_QUERIES, cs.DIM)).astype(np.float32)).cuda()
    c = torch.from_numpy(rng.standard_normal(
        (cs.N_CORPUS, cs.DIM)).astype(np.float32)).cuda()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    big = torch.randn((cs.BIG_ROWS, cs.DIM), generator=gen, device="cuda")
    qbig = {b: torch.randn((b, cs.DIM), generator=gen, device="cuda")
            for b in (8, 256)}
    cp, cbp = F.prepare_corpus(c, "cosine", precision="bf16x3")
    qp = F.prepare_queries(q, "cosine", "bf16x3")
    cpb, cbpb = F.prepare_corpus(big, "cosine", precision="bf16x3")
    # (label, f32 q, f32 c, prepared q, c, bias, k, listed (tiles, tn, br))
    cells = [(f"canonical k={k}", q, c, qp, cp, cbp, k, None)
             for k in (10, 100, 512)]
    cells += [(f"2M x 256 batch {b} k=10", qbig[b], big,
               F.prepare_queries(qbig[b], "cosine", "bf16x3"), cpb, cbpb,
               10, None) for b in (8, 256)]
    gen2 = torch.Generator(device="cuda")
    gen2.manual_seed(cs.SEED + 2)
    c2, queries2 = cs._blobs(torch, gen2, cs.BIG_ROWS, cs.DIM)
    proxy = pmt.ClusteredCorpus(c2)
    del c2
    q2 = queries2(cs.N_QUERIES)
    qr, lqp, lcp, lcbp, core, tiles, br = cs._listed_operands(
        F, proxy, q2, 10, cs.PROBE)
    assert core == "bf16x3", core
    cells.append(("2M x 256 f32 clustered probe 0.05 1000 q k=10", qr,
                  None, lqp, lcp, lcbp, 10,
                  (tiles, proxy.layout.tn, br)))

    def geometry(qp_, cp_, k, listed, tm=None):
        m = qp_.shape[0]
        if listed is None:
            return F.kernel_geometry(m, cp_.shape[0], k, "bf16x3", dev, tm,
                                     dim=cs.DIM)
        tiles_, tn, br_ = listed
        tm = tm or F.listed_tile_rows(m, k, br_)
        return F.kernel_geometry(m, tiles_.shape[1] * tn, k, "bf16x3", dev,
                                 tm, listed=True, dim=cs.DIM)

    def launch(qp_, cp_, cb_, k, listed, geo):
        tm, splits, tps = geo
        extra = () if listed is None else listed
        return F.fused_topk_partial(qp_, cp_, cb_, None, k, "bf16x3",
                                    splits, tps, tm, *extra)

    # Bits at one geometry (this tree's; forced tiles on the canonical
    # operands).
    checks = [(f"canonical k=10 at tm {tm}", qp, cp, cbp, 10, None,
               F.launch_geometry(cs.N_QUERIES, cs.N_CORPUS, 10, sms, 2, tm))
              for tm in (16, 32, 64)]
    use("change")
    checks += [(label, qp_, cp_, cb_, k, listed,
                geometry(qp_, cp_, k, listed))
               for label, _, _, qp_, cp_, cb_, k, listed in cells]
    for label, qp_, cp_, cb_, k, listed, geo in checks:
        outs = {}
        for name in libs:
            use(name)
            outs[name] = launch(qp_, cp_, cb_, k, listed, geo)
        torch.cuda.synchronize()
        pv, pi = outs["parent"]
        v, i = outs["change"]
        equal = torch.equal(v, pv) and torch.equal(i, pi)
        fin = torch.isfinite(pv)
        diff = float((v[fin] - pv[fin]).abs().max()) if fin.any() else 0
        print(f"bits: {label} (tm={geo[0]}, splits={geo[1]}): change "
              f"against the parent: equal {equal}, largest score "
              f"difference {diff:.3g}")
        if not equal:
            raise RuntimeError(f"{label}: the change differs from the "
                               f"parent on the same mma.sync products")

    order = list(libs) + list(reversed(list(libs)))
    for label, qf, cf, qp_, cp_, cb_, k, listed in cells:
        times = {}
        for name in order:
            use(name)
            geo = geometry(qp_, cp_, k, listed)
            ms = cs.cuda_ms(lambda: launch(qp_, cp_, cb_, k, listed, geo),
                            reps=args.reps)
            times.setdefault(name, []).append((ms, geo))
        m, n = qp_.shape[0], cp_.shape[0]
        rows = n if listed is None else listed[0].shape[1] * listed[1]
        lists = 1 if listed is None else listed[0].shape[0]
        splits = times["change"][0][1][1]
        bound = cs._bound(lists * rows * (cp_.shape[1] * 2 + 4) + qp_.nbytes
                          + m * splits * k * 8, 3 * 2 * m * rows * cs.DIM,
                          "bfloat16")
        if listed is None:
            qn = qf / qf.norm(dim=1, keepdim=True)
            cn = cf / cf.norm(dim=1, keepdim=True)
            zero = torch.zeros(n, device="cuda")

            def library():
                with exact_matmul():
                    return torch.topk(torch.addmm(zero, qn, cn.T), k, dim=1)

            lib = f"{cs.cuda_ms(library, reps=10):.4f} ms"
        else:
            lib = "in chip_smoke.py phase 6"
        print(f"[{card}] {label}: " + "; ".join(
            f"{name} {' / '.join(f'{ms:.4f}' for ms, _ in ts)} ms (tm "
            f"{ts[0][1][0]}, splits {ts[0][1][1]})"
            for name, ts in times.items())
            + f" | bound {bound[0]:.4f} ms ({bound[1]}) | torch.addmm + "
            f"torch.topk f32 {lib}")
    shutil.rmtree(work, ignore_errors=True)
    print("ab_kernel_a: done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
