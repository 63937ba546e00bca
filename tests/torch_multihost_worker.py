"""Worker process of tests/test_torch_multihost.py (not a test module).

    python tests/torch_multihost_worker.py RANK RANKS PORT [cpu|cuda]

One of N ranks of a process group: it starts the group through the
port's ``init_distributed`` with the JAX package's keyword names (gloo
on the CPU, where each rank brings 4 ``cpu`` mesh positions; NCCL with
``cuda``, one card a rank), builds meshes that span the ranks, and runs
``distributed_topk`` (allgather and ring merges, big k, int8 shards, a
probed ``ClusteredCorpus``, a data axis across ranks),
``distributed_matmul`` and the dryrun, each against a NumPy float64
oracle computed alike in every rank.  It imports nothing of JAX.  Prints
MULTIHOST_OK on success.
"""

import sys


def main() -> None:
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    kind = sys.argv[4] if len(sys.argv) > 4 else "cpu"

    import numpy as np
    import torch

    import polars_matmul_tpu_torch as pt
    from polars_matmul_tpu_torch.kernels.storage import quantize_stored
    from polars_matmul_tpu_torch.parallel.mesh import (init_distributed,
                                                       make_mesh)

    init_distributed(coordinator_address=f"127.0.0.1:{port}",
                     num_processes=nproc, process_id=pid,
                     backend="gloo" if kind == "cpu" else "nccl")
    assert torch.distributed.get_world_size() == nproc
    assert "jax" not in sys.modules
    # This rank's positions: 4 on the CPU, its own card under NCCL.
    local = ["cpu"] * 4 if kind == "cpu" else ["cuda"]
    per = len(local)

    mesh = make_mesh(1, per * nproc, devices=local)
    assert set(mesh.ranks.flat) == set(range(nproc)), "mesh spans no ranks"
    assert len(mesh.positions()) == per

    rng = np.random.default_rng(321)
    q = rng.standard_normal((19, 48)).astype(np.float32)
    c = rng.standard_normal((203, 48)).astype(np.float32)  # 203 % 8 pads
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    cn = c / np.linalg.norm(c, axis=1, keepdims=True)
    s = qn.astype(np.float64) @ cn.astype(np.float64).T

    def check(v, i, ref_s, k, tag, rtol=2e-5, atol=8e-6):
        """Scores within tolerance of the float64 oracle, indices equal
        except between tied scores."""
        ref_i = np.argsort(-ref_s, axis=1, kind="stable")[:, :k]
        ref_v = np.take_along_axis(ref_s, ref_i, 1)
        v = v.cpu().numpy().astype(np.float64)
        i = i.cpu().numpy()
        assert v.shape == ref_v.shape, (tag, v.shape)
        assert np.allclose(v, ref_v, rtol=rtol, atol=atol), (
            f"{tag}: scores diverge by {np.abs(v - ref_v).max():.2e}")
        mism = i != ref_i
        assert np.all(np.abs(v[mism] - ref_v[mism])
                      <= atol + rtol * np.abs(ref_v[mism])), (
            f"{tag}: index mismatch without a score tie")

    for merge in ("allgather", "ring"):
        cfg = pt.SearchConfig(merge=merge)
        sharded = pt.shard_corpus(c, mesh, cfg)
        assert sharded.n_true == c.shape[0]
        v, i = pt.distributed_topk(q, sharded, 10, "cosine", mesh, cfg)
        check(v, i, s, 10, merge)
        # k above a shard's rows (26 a shard): the big-k merge.
        v, i = pt.distributed_topk(q, sharded, 150, "cosine", mesh, cfg)
        check(v, i, s, 150, f"{merge} k=150")

    # int8 shards: the oracle is exact search over the dequantised rows.
    codes, scales = quantize_stored(
        c, "int8", 48, torch.device("cpu"), 1 << 20)
    cd = codes.astype(np.float64) * scales[:, None]
    s8 = qn.astype(np.float64) @ (
        cd / np.linalg.norm(cd, axis=1, keepdims=True)).T
    sh8 = pt.shard_corpus(codes, mesh, scales=scales, storage="int8")
    v8, i8 = pt.distributed_topk(q, sh8, 10, "cosine", mesh)
    check(v8, i8, s8, 10, "int8", rtol=2e-4, atol=1e-5)

    out = pt.distributed_matmul(q, pt.shard_corpus(c, mesh), mesh)
    assert np.allclose(out.cpu().numpy(), q @ c.T, rtol=1e-5, atol=1e-5)

    # A data axis across ranks: each rank runs the query blocks of its
    # positions and every rank gets every block.
    mesh2 = make_mesh(2, per * nproc // 2, devices=local)
    assert mesh2.ranks[0, 0] != mesh2.ranks[1, 0], "data axis spans no ranks"
    for merge in ("allgather", "ring"):
        cfg = pt.SearchConfig(merge=merge)
        v2, i2 = pt.distributed_topk(q[:16], pt.shard_corpus(c, mesh2, cfg),
                                     10, "cosine", mesh2, cfg)
        check(v2, i2, s[:16], 10, f"data axis {merge}")

    # Probed search across ranks.
    rngb = np.random.default_rng(99)
    centers = rngb.standard_normal((6, 48)).astype(np.float32) * 4
    cb = (centers[rngb.integers(0, 6, 1500)]
          + 0.3 * rngb.standard_normal((1500, 48))).astype(np.float32)
    qb = (centers[rngb.integers(0, 6, 16)]
          + 0.3 * rngb.standard_normal((16, 48))).astype(np.float32)
    cm = pt.ClusteredCorpus(cb, clusters=6, mesh=mesh)
    qbn = qb / np.linalg.norm(qb, axis=1, keepdims=True)
    cbn = cb / np.linalg.norm(cb, axis=1, keepdims=True)
    sb = qbn.astype(np.float64) @ cbn.astype(np.float64).T
    ref_i = np.argsort(-sb, axis=1, kind="stable")[:, :5]
    ei, ev = cm.topk(qb, 5, "cosine")
    assert np.array_equal(ei, ref_i) or np.allclose(
        ev, np.take_along_axis(sb, ref_i, 1), rtol=2e-5, atol=8e-6)
    pi, _ = cm.topk(qb, 5, "cosine", probe=0.6)
    recall = np.mean([len(set(a) & set(b)) / 5 for a, b in zip(pi, ref_i)])
    assert recall > 0.8, f"probed mesh recall {recall:.2f}"

    from polars_matmul_tpu_torch.tools.dryrun import dryrun_multichip

    dryrun_multichip(local)
    torch.distributed.destroy_process_group()
    print("MULTIHOST_OK", flush=True)


if __name__ == "__main__":
    main()
