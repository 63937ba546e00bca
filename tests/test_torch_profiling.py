"""utils.profiling of the PyTorch port: ``block``, ``benchmark`` and the
roofline against a card's published peaks (NVIDIA's H100 SXM data sheet),
with the card's name monkeypatched where a test needs one."""

import pytest
import torch

from polars_matmul_tpu.utils import profiling as JP
from polars_matmul_tpu_torch.utils import profiling as P

H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture
def h100(monkeypatch):
    monkeypatch.setattr(P, "device_name", lambda device=None: H100)


def test_block_on_the_cpu_returns_its_argument():
    x = torch.ones(3)
    for value in (x, (x, [x]), {"a": x}, 3):
        assert P.block(value) is value


def test_benchmark_returns_the_jax_packages_keys():
    calls = []
    stats = P.benchmark(lambda a, b=1: calls.append(b) or a * b,
                        torch.ones(4), b=2, warmup=2, iters=5)
    assert set(stats) == {"min_ms", "median_ms", "mean_ms", "iters"}
    assert stats["iters"] == 5.0 and isinstance(stats["iters"], float)
    assert 0 <= stats["min_ms"] <= stats["median_ms"]
    assert stats["min_ms"] <= stats["mean_ms"]
    assert calls == [2] * 7
    jstats = JP.benchmark(lambda: 1, warmup=0, iters=1)
    assert set(jstats) == set(stats)


@pytest.mark.parametrize("dtype,peak", [("bfloat16", 989.0),
                                        ("float32", 989.0 / 3),
                                        ("float32_cuda_cores", 67.0),
                                        ("int8", None)])
def test_h100_peaks(h100, dtype, peak):
    assert P.device_peak_tflops(dtype) == peak


def test_h100_hbm_and_roofline(h100):
    assert P.device_hbm_bytes_per_s() == 3.35e12
    # 2 * 1000 * 10000 * 256 flops in 0.2 ms against the f32 CUDA cores
    r = P.roofline(2 * 1000 * 10_000 * 256, 0.2e-3, "float32_cuda_cores")
    assert r["achieved_gflops"] == pytest.approx(25_600.0)
    assert r["peak_tflops"] == 67.0
    assert r["fraction_of_peak"] == pytest.approx(25.6 / 67.0)
    # the default denominator: bf16x3's f32-accurate ceiling
    assert P.roofline(1e12, 1.0)["peak_tflops"] == pytest.approx(989 / 3)


@pytest.mark.parametrize("name", ["NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB",
                                  "TPU v5 lite"])
def test_other_cards_report_no_peak(monkeypatch, name):
    monkeypatch.setattr(P, "device_name", lambda device=None: name)
    assert P.device_peak_tflops("bfloat16") is None
    assert P.device_hbm_bytes_per_s() is None
    assert P.roofline(1e9, 1e-3) == {"achieved_gflops": 1000.0}


def test_no_card_reports_no_peak():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert P.device_name() is None
    assert P.device_peak_tflops() is None
    assert P.roofline(1e9, 1e-3, "bfloat16") == {"achieved_gflops": 1000.0}


def test_no_tpu_figure_in_the_table():
    for name, peaks in P._PEAK_TFLOPS.items():
        assert "tpu" not in name and not name.startswith("v")
        assert peaks["float32"] == peaks["bfloat16"] / 3
