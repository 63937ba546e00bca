"""The port's experiments (``polars_matmul_tpu_torch/tools/``) run end to
end on the CPU at tiny sizes, where every kernel wrapper runs its plain
version: the floors JSON keeps every key of the JAX schema
(``tools/floors.json``), nothing of the port imports JAX, and kernel D's
wrapper raises for a device that is neither the CPU nor CUDA."""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from polars_matmul_tpu_torch.kernels import floor as D
from polars_matmul_tpu_torch.kernels import fused_topk as F
from polars_matmul_tpu_torch.tools import exp_b256, exp_floor, exp_int4

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


def _plain_only():
    assert D.launches["floor_stacks"] == 0
    assert D.launches["floor_stacks_plain"] > 0
    assert F.launches["fused_topk_partial"] == 0


def test_exp_floor_writes_the_jax_schema(tmp_path):
    D.reset_launch_counts()
    F.reset_launch_counts()
    out = tmp_path / "floors.json"
    floors = exp_floor.main("cpu", out, m=40, n=600, dim=64, iters=1)
    saved = json.loads(out.read_text())
    assert saved == json.loads(json.dumps(floors))
    jax_keys = set(json.loads((ROOT / "tools" / "floors.json").read_text()))
    assert jax_keys <= set(saved), jax_keys - set(saved)
    assert saved["device_kind"] == "cpu" and saved["card"] == "cpu"
    assert saved["workload"] == "40x600x64d f32 cosine (canonical)"
    assert saved["provenance"] == (
        "polars_matmul_tpu_torch/tools/exp_floor.py")
    for key, value in saved.items():
        if key.endswith("_ms") or key.startswith("fraction_"):
            assert math.isfinite(value) and value > 0, key
    for tag, _, tn, _ in exp_floor.PROGRAMS:
        assert saved["geometry"][tag]["rows"] == tn   # 600 rows, one tile
    _plain_only()


def test_exp_b256_stages(capsys):
    D.reset_launch_counts()
    F.reset_launch_counts()
    res = exp_b256.main("cpu", n=5000, dim=64, b=16, iters=1)
    n_levels = res["n_levels"]
    assert (res["tn"], res["rows"], res["n_segs"]) == (4096, 8192, 1)
    assert n_levels == D._gstack_geometry(8192 // 128, 100)[3]
    for tag in ("full", "kernel-A", "matmul+epi(L0)", "L1", f"L{n_levels}",
                f"L{n_levels}-posu", "finish-kernel-B",
                "finish-torch.topk"):
        assert res[tag] > 0, tag
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["tag"] for x in lines][:4] == ["setup", "full", "kernel-A",
                                             "geom"]
    _plain_only()


def test_exp_int4_modes():
    D.reset_launch_counts()
    F.reset_launch_counts()
    res = exp_int4.main("cpu", n=3000, dim=256, iters=1)
    assert res["tn"] == 2048
    for b in exp_int4.BATCHES:
        for tag, core, _ in exp_int4.MODES:
            row = res[f"{tag}-b{b}"]
            assert row["ms"] > 0 and row["tm"] in (16, 32, 64)
            assert ("kernel_a_ms" in row) == (core in ("int8c", "int4c"))
            # No card: no HBM bound is claimed.
            assert "hbm_bound_ms" not in row
    assert row["corpus_gb"] == 4096 * 128 / 1e9
    assert D.core_launches == {core: 0 for core in D.CORES}
    _plain_only()


def test_port_tools_import_no_jax():
    code = ("import sys; import polars_matmul_tpu_torch.tools.exp_floor, "
            "polars_matmul_tpu_torch.tools.exp_b256, "
            "polars_matmul_tpu_torch.tools.exp_int4, "
            "polars_matmul_tpu_torch.kernels.floor; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'polars_matmul_tpu' or "
            "m.startswith('polars_matmul_tpu.')]; assert not bad, bad")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("core", D.CORES)
def test_floor_stacks_raises_off_cpu_and_cuda(core):
    dim, n = 64, 256
    qp = torch.zeros((8, 2 * dim), dtype=torch.bfloat16, device="meta")
    cp = torch.zeros((n, {"bf16x3": 2 * dim, "int8c": dim}.get(core,
                                                                dim // 2)),
                     dtype=torch.bfloat16 if core == "bf16x3" else torch.int8,
                     device="meta")
    cb = torch.zeros((1 if core == "bf16x3" else 2, n), device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        D.floor_stacks(qp, cp, cb, core=core, levels=1, tn=128)
