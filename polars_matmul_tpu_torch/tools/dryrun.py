"""A dry run of sharded search over a mesh (the port's counterpart of the
JAX package's ``__graft_entry__.dryrun_multichip``).

    python -m polars_matmul_tpu_torch.tools.dryrun
    python -m polars_matmul_tpu_torch.tools.dryrun --devices cuda:0 cuda:0
    python -m polars_matmul_tpu_torch.tools.dryrun --devices cpu cpu cpu cpu

``dryrun_multichip(devices)`` builds a mesh over ``devices`` (a device may
repeat; in a process group every rank passes its own and the mesh spans
them; None takes the visible cards, as ``make_mesh`` does, and raises
without one), two query blocks on the data axis where the positions allow, and
drives the sharded surface: ``distributed_topk`` with the allgather and
the pipelined ring merges, ``distributed_matmul``, k=200 over shards of
more than 128 rows, int8 shards against the dequantised oracle, shards of
more than 16,384 rows at k=20, and a ``ClusteredCorpus(mesh=)`` with
probed and exhaustive search, ``update`` and ``add``.  Every result is
held to the plain reference on the CPU (``ops.reference.topk_search``).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"dryrun: {what}")


def dryrun_multichip(devices: Optional[Sequence] = None) -> None:
    import polars_matmul_tpu_torch as pt
    from polars_matmul_tpu_torch.kernels.storage import quantize_stored
    from polars_matmul_tpu_torch.ops.reference import topk_search

    n_devices = pt.make_mesh(1, None, devices=devices).size
    n_data = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    mesh = pt.make_mesh(n_data, n_devices // n_data, devices=devices)
    n_corpus_shards = n_devices // n_data

    def oracle(q, c, k):
        v, i = topk_search(torch.from_numpy(q), torch.from_numpy(c), k,
                           "cosine")
        return v.numpy(), i.numpy()

    def close(got, want, rtol, atol):
        return np.allclose(got.cpu().numpy(), want, rtol=rtol, atol=atol)

    rng = np.random.default_rng(1)
    m, n, d, k = 16, 96, 32, 5
    q = rng.standard_normal((m, d)).astype(np.float32)
    c = rng.standard_normal((n, d)).astype(np.float32)
    sharded = pt.shard_corpus(c, mesh)
    vals, idx = pt.distributed_topk(q, sharded, k, "cosine", mesh)
    ring_cfg = pt.SearchConfig(merge="ring", ring_pipeline=2)
    vals_r, idx_r = pt.distributed_topk(q, sharded, k, "cosine", mesh,
                                        ring_cfg)
    out = pt.distributed_matmul(q, sharded, mesh)
    v0, i0 = oracle(q, c, k)
    _require(close(vals, v0, 1e-5, 1e-6), "allgather scores")
    _require(close(vals_r, v0, 1e-5, 1e-6), "ring scores")
    _require(np.array_equal(idx.cpu().numpy(), i0)
             and np.array_equal(idx_r.cpu().numpy(), i0), "indices")
    _require(close(out, q @ c.T, 1e-4, 1e-4), "distributed_matmul")

    # Big k: every shard must hold more than 128 rows for the shard's own
    # k to exceed 128.
    c2 = rng.standard_normal((2048, d)).astype(np.float32)
    sharded2 = pt.shard_corpus(c2, mesh)
    vals_b, _ = pt.distributed_topk(q, sharded2, 200, "cosine", mesh)
    _require(close(vals_b, oracle(q, c2, 200)[0], 1e-4, 1e-4), "k=200")

    # int8 shards: the oracle is exact search over the dequantised rows.
    codes, scales = quantize_stored(c2, "int8", d, torch.device("cpu"),
                                    1 << 20)
    sh8 = pt.shard_corpus(codes, mesh, scales=scales, storage="int8")
    v8, _ = pt.distributed_topk(q, sh8, k, "cosine", mesh)
    cd = (codes.astype(np.float64) * scales[:, None]).astype(np.float32)
    _require(close(v8, oracle(q, cd, k)[0], 2e-4, 1e-5), "int8 shards")

    # Shards of more than 16,384 rows at k=20 (the JAX package's segmented
    # selection on a mesh; here kernel A over a tall shard).
    cg = rng.standard_normal((16_512 * n_corpus_shards, d)).astype(
        np.float32)
    vg, _ = pt.distributed_topk(q, pt.shard_corpus(cg, mesh), 20, "cosine",
                                mesh)
    _require(close(vg, oracle(q, cg, 20)[0], 1e-4, 1e-5), "tall shards")

    # Probed search: striped layout, a probe budget a shard, and the mesh
    # mutations (slack add, in-place update).
    cc = pt.ClusteredCorpus(np.ascontiguousarray(np.tile(c, (3, 1))),
                            clusters=4, mesh=mesh)
    pi, _ = cc.topk(q, k, "cosine", probe=0.5)
    _require(pi.shape == (m, k), "probed shape")
    ei, _ = cc.topk(q, k, "cosine")
    _require(ei.shape == (m, k), "exhaustive shape")
    cc.update(np.arange(2), c[:2] * 2.0)
    cc.add(c[:2] + 1.0)
    ei2, _ = cc.topk(q, k, "cosine")
    _require(ei2.shape == (m, k), "shape after the mutations")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", nargs="+", default=None,
                    help="this rank's devices (a device may repeat; "
                         "default: the visible cards)")
    args = ap.parse_args(argv)
    dryrun_multichip(args.devices)
    print(f"dryrun_multichip({args.devices}) OK")


if __name__ == "__main__":
    main()
