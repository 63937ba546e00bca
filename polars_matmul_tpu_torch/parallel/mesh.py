"""The device mesh and the process group (port of
``polars_matmul_tpu.parallel.mesh``).

The JAX package names a ``Mesh`` of devices with axes ``("data",
"corpus")`` and lets XLA compile the collectives.  Here the idiom is
torch's: one process (a rank) per card, the collectives of
``torch.distributed`` outside the kernels.  A mesh position is a (rank,
``torch.device``) pair, and a rank may own several positions, as a JAX
process owns several devices.  The contract is JAX's SPMD one: every rank
runs the same program with the same arguments, keeps only the shards its
positions own, and gets the whole result.

``devices=`` may name one device several times: ``make_mesh(1, 8,
devices=["cpu"] * 8)`` gives eight shards on the CPU, and
``make_mesh(1, 4, devices=["cuda:0"] * 4)`` four shards on one card.  Two
ranks cannot share one card under NCCL, so a card's positions belong to
one rank.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

# JAX's keyword names of jax.distributed.initialize and torch's.
_JAX_NAMES = {"coordinator_address": "init_method",
              "num_processes": "world_size", "process_id": "rank"}


def _distributed() -> bool:
    return torch.distributed.is_available() and \
        torch.distributed.is_initialized()


def init_distributed(**kwargs) -> None:
    """Start the process group (``torch.distributed.init_process_group``).

    Takes JAX's keywords (``coordinator_address="host:port"``,
    ``num_processes``, ``process_id``) or torch's (``init_method``,
    ``world_size``, ``rank``, ``backend``, ``timeout``).  The backend is
    NCCL where a CUDA device is available, gloo on the CPU; with NCCL the
    rank's current device becomes card ``LOCAL_RANK`` (else the rank)
    modulo the cards it sees, so each rank has a card of its own.
    """
    kw = {}
    for key, value in kwargs.items():
        if key == "coordinator_address" and "://" not in str(value):
            value = f"tcp://{value}"
        kw[_JAX_NAMES.get(key, key)] = value
    backend = kw.pop("backend", None) or (
        "nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        rank = int(kw.get("rank", os.environ.get("RANK", 0)))
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    torch.distributed.init_process_group(backend=backend, **kw)


def _device(d) -> torch.device:
    """A device with its index: "cuda" is the current card."""
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A (n_data, n_corpus) grid of positions, each a (rank, device) pair.

    ``shape`` maps each axis name to its size, as a JAX mesh's does, so
    ``mesh.shape[cfg.mesh_axes[1]]`` reads the same in both packages.
    ``devices`` and ``ranks`` are (n_data, n_corpus) arrays; this rank
    owns the positions where ``ranks == rank``.  Queries split into
    n_data row blocks; the corpus splits into n_corpus row shards, each
    held by every position of its column.
    """

    def __init__(self, ranks: np.ndarray, devices: np.ndarray,
                 axis_names: Tuple[str, str], home: torch.device):
        self.ranks = ranks
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, ranks.shape))
        self.distributed = _distributed()
        self.rank = torch.distributed.get_rank() if self.distributed else 0
        self.world_size = (torch.distributed.get_world_size()
                           if self.distributed else 1)
        # Where this rank's requests gather their results: its first
        # position's device (its first device if it owns none).
        owned = self.positions()
        self.home = self.devices[owned[0]] if owned else home

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def positions(self, rank: Optional[int] = None) -> List[Tuple[int, int]]:
        """(data, corpus) positions of ``rank`` (default this rank), in
        row-major order."""
        rank = self.rank if rank is None else rank
        return [tuple(int(x) for x in p)
                for p in np.argwhere(self.ranks == rank)]

    def shard_devices(self, s: int) -> List[torch.device]:
        """The devices of this rank holding corpus shard ``s``, each
        once."""
        out = []
        for d in range(self.ranks.shape[0]):
            dev = self.devices[d, s]
            if self.ranks[d, s] == self.rank and dev not in out:
                out.append(dev)
        return out

    def __repr__(self) -> str:
        grid = ", ".join(f"{name}={size}" for name, size in
                         self.shape.items())
        return (f"Mesh({grid}, rank {self.rank} of {self.world_size}, "
                f"home {self.home})")


def make_mesh(n_data: int = 1, n_corpus: Optional[int] = None, *,
              axis_names: Tuple[str, str] = ("data", "corpus"),
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a (n_data, n_corpus) mesh over the available devices.

    ``devices`` are this rank's devices (torch devices or strings; one
    may repeat).  Left out, they are every visible CUDA device, or, in a
    process group, the rank's current card; with no CUDA device this
    raises (the mesh never falls back to the CPU unless asked).  In a
    process group every rank's devices join, rank by rank, so the data
    axis spans ranks first.  ``n_corpus=None`` uses all remaining
    positions on the corpus axis.
    """
    dist_on = _distributed()
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh found no CUDA device; pass devices= (for "
                "example ['cpu'] * 8) to build a mesh on the CPU")
        local = ([_device("cuda")] if dist_on else
                 [torch.device("cuda", i)
                  for i in range(torch.cuda.device_count())])
    else:
        local = [_device(d) for d in devices]
    if dist_on:
        world = torch.distributed.get_world_size()
        gathered = [None] * world
        torch.distributed.all_gather_object(gathered,
                                            [str(d) for d in local])
        entries = [(r, torch.device(d)) for r in range(world)
                   for d in gathered[r]]
    else:
        entries = [(0, d) for d in local]
    if n_corpus is None:
        if len(entries) % n_data != 0:
            raise ValueError(
                f"{len(entries)} devices not divisible by n_data={n_data}"
            )
        n_corpus = len(entries) // n_data
    need = n_data * n_corpus
    if need > len(entries):
        raise ValueError(
            f"Mesh {n_data}x{n_corpus} needs {need} devices, "
            f"have {len(entries)}"
        )
    ranks = np.array([r for r, _ in entries[:need]]).reshape(n_data,
                                                             n_corpus)
    devs = np.empty(need, dtype=object)
    devs[:] = [d for _, d in entries[:need]]
    return Mesh(ranks, devs.reshape(n_data, n_corpus), axis_names,
                local[0])
