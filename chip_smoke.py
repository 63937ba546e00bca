#!/usr/bin/env python3
"""Smoke run of polars_matmul_tpu_torch on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Phases, each printing one line or a few:

0. the card (nvidia-smi name and power limit), torch and CUDA versions;
1. build of the CUDA kernels from this checkout's sources (nvcc, sm_90a);
2. each kernel against its plain PyTorch version on the card, over ragged
   shapes and at the shapes phases 3 and 4 give it, every metric and
   precision, with and without a mask, with duplicate rows, and on integer
   tie data where the results must be bit-identical;
3. the canonical workload (1000 queries x 10,000 rows x 256 dims, f32,
   cosine, seed 42) through ``topk`` and a resident ``Corpus`` at k=10,
   k=100, k=512 and precision="highest", each held to a float64 NumPy
   oracle;
4. a 2,000,000 x 256 resident corpus answering requests of 8 and 256
   queries at k=10 and k=100, each held to a float64 oracle on the card;
5. the launch counts of phases 3 and 4: both kernels ran, the plain
   versions did not;
6. times from CUDA events: kernels against plain versions, and requests.

The line before the last is a JSON object of per-kernel results; the last
is {"ok": true, "device": {...}}.  Any failure exits non-zero with its
traceback and prints no result; so does a machine without a CUDA device.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 42
N_QUERIES, N_CORPUS, DIM = 1000, 10_000, 256
BIG_ROWS = 2_000_000
# Kernel against plain version: the f32 sums run in another order, and
# their rounding error scales with the terms summed, not with the result.
# So a score may differ by ATOL + RTOL * max(|score|, scale), where scale
# is the row's term scale |q_i| * max_j |c_j| + max_j |bias_j|.
RTOL, ATOL = 1e-5, 2e-6
KERNEL_SRC = "polars_matmul_tpu_torch/kernels/csrc/"
TPU_KERNEL = "polars_matmul_tpu/kernels/fused_topk.py"


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def compare(v, i, v_ref, i_ref, rtol=RTOL, atol=ATOL, scale=0.0, what="",
            exact=False):
    """Top-k results agree: the same -inf slots, finite scores within
    tolerance, and indices equal except where the two scores tie within
    it; with ``exact``, scores and indices are bit-identical.  Returns the
    largest absolute score difference."""
    import torch

    require(v.shape == v_ref.shape, f"{what}: shape {v.shape} != "
            f"{v_ref.shape}")
    if exact:
        require(torch.equal(v, v_ref), f"{what}: scores differ")
        require(torch.equal(i, i_ref), f"{what}: indices differ")
        return 0.0
    inf_a, inf_b = torch.isinf(v), torch.isinf(v_ref)
    require(torch.equal(inf_a, inf_b) and torch.equal(v[inf_a], v_ref[inf_b]),
            f"{what}: infinite slots differ")
    fin = ~inf_a
    diff = torch.where(fin, (v - v_ref).abs(), torch.zeros_like(v))
    tol = atol + rtol * torch.maximum(
        v_ref.abs(), torch.as_tensor(scale, device=v_ref.device))
    worst = float(diff.max().item()) if diff.numel() else 0.0
    require(bool((diff[fin] <= tol[fin]).all()),
            f"{what}: scores differ by up to {worst}")
    mism = i != i_ref
    require(bool((diff[mism & fin] <= tol[mism & fin]).all())
            and torch.equal(i[mism & inf_a], i_ref[mism & inf_a]),
            f"{what}: index mismatch without a score tie")
    return worst


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of fn() in ms, from CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def numpy_oracle(q, c, k):
    """bench.py's float64 cosine oracle."""
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    cn = c / np.linalg.norm(c, axis=1, keepdims=True)
    s = qn.astype(np.float64) @ cn.astype(np.float64).T
    idx = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return idx, np.take_along_axis(s, idx, 1)


def gate(idx, scores, ref_idx, ref_scores, what: str) -> None:
    """bench.py's correctness gate: scores within rtol 1e-4 / atol 1e-5,
    index differences only on tied scores."""
    require(idx.shape == ref_idx.shape, f"{what}: shape {idx.shape}")
    require(bool(np.isfinite(scores).all()), f"{what}: non-finite scores")
    require(np.allclose(scores, ref_scores, rtol=1e-4, atol=1e-5),
            f"{what}: scores off by "
            f"{np.abs(scores - ref_scores).max()}")
    mism = idx.astype(np.int64) != ref_idx
    require(bool(np.all(np.abs(scores[mism] - ref_scores[mism])
                        <= 1e-5 + 1e-4 * np.abs(ref_scores[mism]))),
            f"{what}: index mismatch without a score tie")


def phase_card():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"phase 0: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s), "
          f"{torch.cuda.get_device_name(0)}")
    return card


def phase_build():
    from polars_matmul_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.load_library()
    print(f"phase 1: kernels built and loaded in "
          f"{time.perf_counter() - t0:.1f} s -> {_build.build_info['path']}")
    for line in str(_build.build_info["log"]).splitlines():
        if "Used" in line or "spill" in line or "Compiling" in line:
            print("  ptxas: " + line.strip())


def _case_data(torch, gen, m, n, dim, dup: bool):
    q = torch.randn((m, dim), generator=gen, device="cuda")
    c = torch.randn((n, dim), generator=gen, device="cuda")
    if dup and n > 2:
        c[n // 2:] = c[: n - n // 2].clone()   # every row has a twin
        q[:] = c[0]                             # and ties at the top
    return q, c


def _tie_data(torch, gen, m, n, dim):
    """Integer entries in [-2, 2], every row twinned: dot and euclidean
    scores are exact in f32 in any summation order (and bf16 splits them
    with lo = 0), so the kernels must match their plain versions bit for
    bit, tie order included."""
    c = torch.randint(-2, 3, (n, dim), generator=gen, device="cuda").float()
    c[n // 2:] = c[: n - n // 2].clone()
    q = torch.randint(-2, 3, (m, dim), generator=gen, device="cuda").float()
    return q, c


def _term_scale(qp, cp, cbp):
    """Row term scale |q_i| * max_j |c_j| + max_j |bias_j| (see RTOL)."""
    return (qp.float().norm(dim=1, keepdim=True)
            * cp.float().norm(dim=1).max() + cbp.abs().max())


def _check_kernels(F, qp, cp, cbp, mask, k, precision, sms, err, what,
                   scale=0.0, exact=False):
    """At the geometry the main path picks for this shape: kernel A
    against its plain version, kernel B against its plain version on A's
    lists (bit-identical), and A + B through ``fused_select`` against the
    plain version of both."""
    import torch

    m, n = qp.shape[0], cp.shape[0]
    tm, splits, tps = F.launch_geometry(m, n, k, sms)
    pv, pi = F.fused_topk_partial(qp, cp, cbp, mask, k, precision, splits,
                                  tps, tm)
    rv, ri = F.fused_topk_partial_plain(qp, cp, cbp, mask, k, precision,
                                        splits, tps)
    part_scale = scale[:, :, None] if torch.is_tensor(scale) else scale
    err["fused_topk_partial"] = max(
        err["fused_topk_partial"],
        compare(pv, pi, rv, ri, scale=part_scale, exact=exact,
                what="kernel A " + what))
    del rv, ri
    v, i = F.topk_merge(pv, pi, k)
    mv, mi = F.topk_merge_plain(pv, pi, k)
    err["topk_merge"] = max(err["topk_merge"], compare(
        v, i, mv, mi, exact=True, what="kernel B " + what))
    sv, si = F.fused_select(qp, cp, cbp, mask, k, precision)
    require(torch.equal(sv, v) and torch.equal(si, i),
            f"fused_select {what}: differs from kernel A then B")
    fv, fi = F.fused_topk_plain(qp, cp, cbp, mask, k, precision)
    compare(v, i, fv, fi, scale=scale, exact=exact, what="A+B " + what)


def _check_shape(F, torch, gen, q, c, ks, sms, err, label, tie=False):
    """Every metric (only dot and euclidean on tie data, whose cosine
    scores are not exact), both precisions, k in ``ks``, with and without
    a mask.  Returns the number of cases."""
    m, n = q.shape[0], c.shape[0]
    keep = torch.rand((n,), generator=gen, device="cuda") < 0.7
    mask_row = F.pad_mask_row(keep, n)
    metrics = ("dot", "euclidean") if tie else ("cosine", "dot", "euclidean")
    cases = 0
    for metric in metrics:
        for precision in ("bf16x3", "highest"):
            qp = F.prepare_queries(q, metric, precision)
            cp, cbp = F.prepare_corpus(c, metric, precision=precision)
            scale = 0.0 if tie else _term_scale(qp, cp, cbp)
            for k in ks:
                for mask in (None, mask_row):
                    what = (f"{label} m={m} n={n} dim={q.shape[1]} k={k} "
                            f"{metric} {precision} "
                            f"mask={mask is not None} tie={tie}")
                    _check_kernels(F, qp, cp, cbp, mask, k, precision, sms,
                                   err, what, scale=scale, exact=tie)
                    cases += 1
            del qp, cp, cbp
    return cases


def phase_compare(F, ms=(1, 37, 300), ns=(1, 129, 5000),
                  dims=(3, 56, 256, 300, 768), ks=(1, 10, 100, 512, 1024)):
    """Kernels A and B against their plain versions on CUDA tensors: over
    a ragged grid of shapes, then at the shapes phases 3 and 4 give them.
    Returns the largest absolute score difference of each kernel."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    err = {"fused_topk_partial": 0.0, "topk_merge": 0.0}
    cases = 0
    shapes = [(m, n, d, False) for m in ms for n in ns for d in dims]
    shapes.append((37, 5000, 56, True))
    for m, n, dim, dup in shapes:
        q, c = _case_data(torch, gen, m, n, dim, dup)
        keep = torch.rand((n,), generator=gen, device="cuda") < 0.7
        for metric in ("cosine", "dot", "euclidean"):
            for precision in ("bf16x3", "highest"):
                qp = F.prepare_queries(q, metric, precision)
                cp, cbp = F.prepare_corpus(c, metric, precision=precision)
                scale = _term_scale(qp, cp, cbp)
                for k in sorted({min(k, n) for k in ks}):
                    mask = (F.pad_mask_row(keep, n) if cases % 2 else None)
                    what = (f"m={m} n={n} dim={dim} k={k} {metric} "
                            f"{precision} mask={mask is not None} dup={dup}")
                    _check_kernels(F, qp, cp, cbp, mask, k, precision, sms,
                                   err, what, scale=scale)
                    cases += 1
    print(f"phase 2: {cases} ragged cases match (atol {ATOL} + rtol {RTOL} "
          f"x max(|score|, row term scale); kernel B bit-identical)")

    main = 0
    for tie in (False, True):
        q, c = (_tie_data(torch, gen, N_QUERIES, N_CORPUS, DIM) if tie else
                _case_data(torch, gen, N_QUERIES, N_CORPUS, DIM, False))
        main += _check_shape(F, torch, gen, q, c, (10, 100, 512), sms, err,
                             "canonical", tie=tie)
        q, c = (_tie_data(torch, gen, 256, BIG_ROWS, DIM) if tie else
                _case_data(torch, gen, 256, BIG_ROWS, DIM, False))
        for batch in (8, 256):
            main += _check_shape(F, torch, gen, q[:batch], c, (10, 100), sms,
                                 err, "2M", tie=tie)
        del q, c
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    print(f"phase 2: {main} cases at the main path's shapes "
          f"({N_QUERIES}x{N_CORPUS}x{DIM} at k=10/100/512, {BIG_ROWS}x{DIM} "
          f"at batch 8/256 and k=10/100; every metric, precision and mask; "
          f"integer tie data bit-identical) match; max abs err A "
          f"{err['fused_topk_partial']:.3g}, B {err['topk_merge']:.3g}")
    return err


CANON_TIERS = ((10, "bf16x3"), (100, "bf16x3"), (512, "bf16x3"),
               (10, "highest"))


def phase_canonical(pmt, q, c):
    ref_idx, ref_scores = numpy_oracle(q, c, 512)
    for k, precision in CANON_TIERS:
        cfg = pmt.SearchConfig(precision=precision)
        idx, scores = pmt.topk(q, c, k, "cosine", config=cfg)
        gate(idx, scores, ref_idx[:, :k], ref_scores[:, :k],
             f"topk k={k} {precision}")
        corpus = pmt.Corpus(c, config=cfg)
        idx, scores = corpus.topk(q, k)
        gate(idx, scores, ref_idx[:, :k], ref_scores[:, :k],
             f"Corpus.topk k={k} {precision}")
        print(f"phase 3: canonical {N_QUERIES}x{N_CORPUS}x{DIM} cosine "
              f"k={k} {precision}: topk and Corpus.topk pass the float64 "
              f"oracle gate")


def _oracle_on_card(torch, q, c, k, chunk=250_000):
    """float64 cosine top-k on the card, in corpus chunks."""
    qn = q.double()
    qn = qn / qn.norm(dim=1, keepdim=True)
    best_v, best_i = [], []
    for r0 in range(0, c.shape[0], chunk):
        cn = c[r0:r0 + chunk].double()
        cn = cn / cn.norm(dim=1, keepdim=True)
        v, i = torch.topk(qn @ cn.T, k, dim=1)
        best_v.append(v)
        best_i.append(i + r0)
    v = torch.cat(best_v, dim=1)
    i = torch.cat(best_i, dim=1)
    v, order = torch.sort(v, dim=1, descending=True, stable=True)
    return (torch.gather(i, 1, order)[:, :k].cpu().numpy(),
            v[:, :k].cpu().numpy())


def phase_big(pmt, torch):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    c = torch.randn((BIG_ROWS, DIM), generator=gen, device="cuda")
    corpus = pmt.Corpus(c)
    requests = {}
    for batch in (8, 256):
        q = torch.randn((batch, DIM), generator=gen, device="cuda")
        for k in (10, 100):
            t0 = time.perf_counter()
            idx, scores = corpus.topk(q, k)   # results land on the host
            first = (time.perf_counter() - t0) * 1e3
            ref_idx, ref_scores = _oracle_on_card(torch, q, c, k)
            gate(idx, scores, ref_idx, ref_scores,
                 f"2M corpus batch={batch} k={k}")
            requests[(batch, k)] = q
            print(f"phase 4: {BIG_ROWS}x{DIM} corpus, batch {batch}, k={k}: "
                  f"passes the float64 oracle gate (first request "
                  f"{first:.1f} ms host, corpus prep included on the "
                  f"first)")
    return corpus, requests


def profile_request(torch, fn, label: str, card: str,
                    host_ms: float) -> None:
    """One request under torch.profiler: device time by kernel, and the
    device's busy share of ``host_ms``, the request's median host time
    measured without the profiler (which slows the host side)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # The package's own record_function ranges ("pmm.*") also carry
    # device time; count only the work itself.
    dev = sorted(((e.self_device_time_total, e.key)
                  for e in prof.key_averages()
                  if e.self_device_time_total > 0
                  and not e.key.startswith("pmm.")), reverse=True)
    busy = sum(t for t, _ in dev)
    if not dev:
        print(f"phase 6: [{card}] {label}: profiler saw no device time "
              f"(not measured)")
        return
    top = ", ".join(f"{name[:48]} {t / 1e3:.4f} ms" for t, name in dev[:5])
    print(f"phase 6: [{card}] {label} profile: device busy "
          f"{busy / 1e3:.4f} ms, {100 * busy / (host_ms * 1e3):.1f} % of the "
          f"{host_ms:.3f} ms request; {top}")


def phase_times(pmt, F, torch, q_np, c_np, corpus_big, requests, card):
    """Device times of kernels and plain versions, and request times."""
    q = torch.from_numpy(q_np).cuda()
    c = torch.from_numpy(c_np).cuda()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_kernel = {}
    for k, precision in CANON_TIERS:
        qp = F.prepare_queries(q, "cosine", precision)
        cp, cbp = F.prepare_corpus(c, "cosine", precision=precision)
        compare(*F.fused_select(qp, cp, cbp, None, k, precision),
                *F.fused_topk_plain(qp, cp, cbp, None, k, precision),
                scale=_term_scale(qp, cp, cbp),
                what=f"timed canonical k={k} {precision}")
        ab = cuda_ms(lambda: F.fused_select(qp, cp, cbp, None, k, precision))
        plain = cuda_ms(lambda: F.fused_topk_plain(qp, cp, cbp, None, k,
                                                   precision))
        tm, splits, tps = F.launch_geometry(N_QUERIES, N_CORPUS, k, sms)
        a = cuda_ms(lambda: F.fused_topk_partial(qp, cp, cbp, None, k,
                                                 precision, splits, tps, tm))
        a_plain = cuda_ms(lambda: F.fused_topk_partial_plain(
            qp, cp, cbp, None, k, precision, splits, tps))
        pv, pi = F.fused_topk_partial(qp, cp, cbp, None, k, precision,
                                      splits, tps, tm)
        b = cuda_ms(lambda: F.topk_merge(pv, pi, k))
        b_plain = cuda_ms(lambda: F.topk_merge_plain(pv, pi, k))
        if (k, precision) == CANON_TIERS[0]:
            per_kernel = {"fused_topk_partial": (a, a_plain),
                          "topk_merge": (b, b_plain)}
        print(f"phase 6: [{card}] canonical k={k} {precision} (tm={tm}, "
              f"splits={splits}): A+B {ab:.4f} ms, plain {plain:.4f} ms | "
              f"A {a:.4f} ms, A plain {a_plain:.4f} ms | B {b:.4f} ms, "
              f"B plain {b_plain:.4f} ms")
    canon = pmt.Corpus(c_np)
    for k in (10, 100, 512):
        canon.topk(q_np, k)
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            canon.topk(q_np, k)
            ts.append((time.perf_counter() - t0) * 1e3)
        print(f"phase 6: [{card}] canonical Corpus.topk k={k} from NumPy: "
              f"{statistics.median(ts):.3f} ms host per 1000-query request")
        profile_request(torch, lambda: canon.topk(q_np, k),
                        f"canonical Corpus.topk k={k}", card,
                        statistics.median(ts))
    for (batch, k), qb in requests.items():
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            corpus_big.topk(qb, k)
            ts.append((time.perf_counter() - t0) * 1e3)
        qp = F.prepare_queries(qb, "cosine", "bf16x3")
        cp, cbp = corpus_big._prepared_for(F.Metric.COSINE)
        dev = cuda_ms(lambda: F.fused_select(qp, cp, cbp, None, k,
                                             "bf16x3"), reps=5)
        print(f"phase 6: [{card}] {BIG_ROWS}x{DIM} corpus batch {batch} "
              f"k={k}: request {statistics.median(ts):.3f} ms host, "
              f"A+B {dev:.3f} ms device")
        profile_request(torch, lambda: corpus_big.topk(qb, k),
                        f"{BIG_ROWS}x{DIM} batch {batch} k={k}", card,
                        statistics.median(ts))
    return per_kernel


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import polars_matmul_tpu_torch as pmt
    from polars_matmul_tpu_torch.kernels import fused_topk as F

    card = phase_card()
    phase_build()
    err = phase_compare(F)

    rng = np.random.default_rng(SEED)
    q = rng.standard_normal((N_QUERIES, DIM)).astype(np.float32)
    c = rng.standard_normal((N_CORPUS, DIM)).astype(np.float32)

    # Phases 3 and 4 are the main path: count only their launches.
    F.reset_launch_counts()
    phase_canonical(pmt, q, c)
    corpus_big, requests = phase_big(pmt, torch)
    torch.cuda.synchronize()
    counts = dict(F.launches)
    print(f"phase 5: launches on the main path: {counts}")
    for name in ("fused_topk_partial", "topk_merge"):
        require(counts[name] > 0, f"{name} never launched on the main path")
    for name in ("fused_topk_plain", "fused_topk_partial_plain",
                 "topk_merge_plain"):
        require(counts[name] == 0, f"{name} ran on the main path")

    per_kernel = phase_times(pmt, F, torch, q, c, corpus_big, requests, card)
    replaces = {"fused_topk_partial": TPU_KERNEL + ":1167",
                "topk_merge": TPU_KERNEL + ":922"}
    source = {"fused_topk_partial": KERNEL_SRC + "fused_topk.cu",
              "topk_merge": KERNEL_SRC + "topk_merge.cu"}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source[name],
         "replaces": replaces[name], "launches": counts[name],
         "max_abs_err": err[name], "ms": per_kernel[name][0],
         "plain_ms": per_kernel[name][1]}
        for name in ("fused_topk_partial", "topk_merge")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
