"""The port's example scripts (``polars_matmul_tpu_torch/examples/``) on the
CPU at tiny sizes, held to the JAX package's ``examples/`` where the two
print comparable results.

Each port script's ``main(argv)`` runs in this process with ``--cpu``,
where every kernel wrapper runs its plain PyTorch version, and its own
checks raise on a wrong result.  Against the JAX scripts, run on the CPU
from their files on the same seeds:

- ``quickstart``: the Arrow surface's rows (and the raw-buffer surface's,
  which the port falls back to without pyarrow) and the NumPy surface's
  printed indices and scores;
- ``serving``: every filtered request, the upserted rows and the reloaded
  corpus's answers (the JAX script is stopped at its ``ClusteredCorpus``
  part: the two packages' k-means differ by design, so their probed
  results do too);
- ``benchmark_topk``: three of its cases' checked results against the
  JAX package's ``Corpus.topk`` on the same draws, and the JAX script's
  own ``verify_correctness`` on those results.

The rest differ by design: the JAX scripts' other output is timing, and
``benchmark_bigcorpus`` / ``benchmark_clustered`` draw their corpora with
``jax.random`` on the TPU where the port draws with ``torch.Generator``;
``benchmark_scaling --cpu`` needs the JAX package's 8 virtual devices
before JAX starts.  Those run here for their own checks (the carry gate on
equal to off, recall 1 at probe 1.0, the exhaustive results unchanged by
``rebuild()``, every sharded result equal to one shard's).  Scores agree
within rtol 1e-4 / atol 5e-4, index differences only on tied scores.
"""

import ast
import importlib
import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import polars_matmul_tpu as pmt

from conftest import assert_topk_equivalent

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "polars_matmul_tpu_torch" / "examples"
NAMES = ("quickstart", "serving", "benchmark_topk", "benchmark_matmul",
         "benchmark_bigcorpus", "benchmark_clustered", "benchmark_scaling")
TOL = dict(rtol=1e-4, atol=5e-4)


def _port(name):
    return importlib.import_module(f"polars_matmul_tpu_torch.examples.{name}")


def _jax_script(name):
    """The JAX package's example script, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_nothing_imports_jax():
    for path in sorted(PORT.glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "polars_matmul_tpu"), (
                    path.name, name)
    code = ("import sys\n"
            + "".join(f"import polars_matmul_tpu_torch.examples.{n}\n"
                      for n in NAMES)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'polars_matmul_tpu')]\n"
              "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


@pytest.mark.parametrize("name", NAMES)
def test_raises_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _port(name).main([])


def _rows_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [e["index"] for e in g] == [e["index"] for e in w]
        np.testing.assert_allclose([e["score"] for e in g],
                                   [e["score"] for e in w], rtol=1e-12)


def test_quickstart_matches_jax(capsys):
    jq = _jax_script("quickstart")
    jax_rows = pmt.topk_arrow(__import__("pyarrow").array(jq.QUERIES),
                              __import__("pyarrow").array(jq.CORPUS),
                              k=2).to_pylist()
    capsys.readouterr()
    jq.with_numpy()
    jax_numpy = capsys.readouterr().out
    q = _port("quickstart")
    for surface in ("pyarrow", "buffers"):
        out = q.main(["--cpu", "--surface", surface])
        printed = capsys.readouterr().out
        assert out["surface"] == surface
        _rows_equal(out["matches"], jax_rows)
        assert printed.endswith(jax_numpy), (printed, jax_numpy)
        np.testing.assert_array_equal(out["indices"], [[0, 1], [1, 0],
                                                       [2, 0]])


class _Stop(Exception):
    pass


def test_serving_matches_jax(monkeypatch):
    """The JAX script's Corpus requests, recorded as it runs, against what
    the port's script returns."""
    js = _jax_script("serving")
    seen = []
    topk = pmt.Corpus.topk

    def spy(self, *args, **kw):
        out = topk(self, *args, **kw)
        seen.append(out)
        return out

    def stop(*args, **kw):
        raise _Stop

    monkeypatch.setattr(pmt.Corpus, "topk", spy)
    monkeypatch.setattr(pmt, "ClusteredCorpus", stop)
    with pytest.raises(_Stop):
        js.main()
    monkeypatch.undo()
    out = _port("serving").main(["--cpu"])
    # warm-up, 5 requests, corpus2's prep, the upserts, the reloaded corpus
    assert len(seen) == 9
    for (want, idx, scores), (ji, jv) in zip(out["requests"], seen[1:6]):
        assert_topk_equivalent(idx.astype(np.int64), scores,
                               ji.astype(np.int64), jv, **TOL)
    np.testing.assert_array_equal(out["upserted"], seen[7][0])
    np.testing.assert_array_equal(out["reloaded"], seen[8][0])
    np.testing.assert_array_equal(out["reloaded"], [[17], [123]])
    assert out["drift"] > 0.25 and out["drift_after"] == 0.0


class _Answered:
    """A corpus handle that answers with results already computed."""

    def __init__(self, idx, scores):
        self.answer = idx, scores

    def topk(self, q, k, metric):
        return self.answer


def test_benchmark_topk_matches_jax():
    """Three of the ten cases: the port script's checked results against
    the JAX package's ``Corpus.topk`` on the same draws, and the JAX
    script's own verdict on the port's results."""
    res = _port("benchmark_topk").main(
        ["--cpu", "--base", "40", "400", "32", "--warmup", "0", "--iters",
         "1"])
    assert len(res["cases"]) == 10
    assert all(case["verified"] for case in res["cases"].values())
    jt = _jax_script("benchmark_topk")
    for name, k, dtype in (("base 40x400x32 k=10 f32", 10, np.float32),
                           ("k=1", 1, np.float32), ("f64", 10, np.float64)):
        rng = np.random.default_rng(42)
        q = rng.standard_normal((40, 32)).astype(dtype)
        c = rng.standard_normal((400, 32)).astype(dtype)
        idx, scores = res["cases"][name]["indices"], res["cases"][name][
            "scores"]
        assert idx.shape == scores.shape == (40, k)
        ji, jv = pmt.Corpus(c).topk(q, k, "cosine")
        assert_topk_equivalent(idx.astype(np.int64), scores,
                               ji.astype(np.int64), jv, **TOL)
        assert jt.verify_correctness(_Answered(idx, scores), q, c, k)


@pytest.mark.parametrize("buffers", [False, True])
def test_benchmark_matmul(buffers):
    res = _port("benchmark_matmul").main(
        ["--cpu", "--shape", "30", "200", "16"]
        + (["--buffers"] if buffers else []))
    assert res["columns"] == ("buffers" if buffers else "pyarrow")
    assert len(res["cases"]) == 7


def test_benchmark_bigcorpus():
    res = _port("benchmark_bigcorpus").main(
        ["--cpu", "--rows", "3000", "--dim", "32", "--batches", "4", "20"])
    assert len(res["rows"]) == 4 * 2 * 2
    assert {r["prune"] for r in res["rows"]} == {"on", "off"}


def test_benchmark_clustered():
    res = _port("benchmark_clustered").main(
        ["--cpu", "--rows", "6000", "--dim", "32", "--clusters", "16",
         "--centers", "12", "--batch", "16"])
    assert [r["probe"] for r in res["rows"]] == [1.0, 0.25, 0.1, 0.05]
    assert res["rows"][0]["recall"] == 1.0
    drift = res["drift"]
    # 6000 rows, then 3000 added against the fitted centroids
    assert drift["drift_before"] == pytest.approx(1 / 3)
    assert drift["exhaustive_ok"] and drift["drift_after"] == 0.0


def test_benchmark_scaling():
    res = _port("benchmark_scaling").main(
        ["--cpu", "--corpus", "3000", "--dim", "32", "--queries", "16",
         "--k", "20"])
    assert [(r["shards"], r["merge"]) for r in res["rows"]] == [
        (1, "allgather"), (2, "allgather"), (2, "ring"), (4, "allgather"),
        (4, "ring"), (8, "allgather"), (8, "ring")]
