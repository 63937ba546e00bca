"""Sharded search across processes: two ranks of a gloo process group on
the CPU, each with 4 ``cpu`` mesh positions (tests/torch_multihost_worker.py),
the port's counterpart of tests/test_multihost.py.  Every rank checks the
whole result against a NumPy float64 oracle.  The workers import no JAX.
"""

import os
import socket
import subprocess
import sys

import pytest

_WORKER = os.path.join(os.path.dirname(__file__), "torch_multihost_worker.py")
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Each worker's own limit: the run takes about 15 s.
_TIMEOUT_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker_env() -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                        "LOCAL_RANK", "PYTHONPATH")}
    env["PYTHONPATH"] = _REPO
    env["OMP_NUM_THREADS"] = "2"
    return env


def test_two_process_distributed_topk():
    nproc = 2
    port = _free_port()
    env = _worker_env()
    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, str(pid), str(nproc), str(port)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in range(nproc)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=_TIMEOUT_S)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multihost workers timed out:\n"
                    + "\n---\n".join(o or "" for o in outs))
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (
            f"worker {pid} exited {p.returncode}:\n{out[-4000:]}")
        assert "MULTIHOST_OK" in out, (
            f"worker {pid} never reached MULTIHOST_OK:\n{out[-4000:]}")
