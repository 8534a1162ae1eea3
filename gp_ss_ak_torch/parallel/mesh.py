"""The port's device mesh: a torch.distributed process group over ranks.

Port of gp_ss_ak_tpu/parallel/mesh.py. JAX's 1-D `Mesh` over devices
with the axis "dp" becomes a `Mesh` over the ranks of a process group:
each rank is one process that drives one device, and the N training rows
are split into contiguous row blocks, one per rank (the GP analogue of
data parallelism). Every function of parallel/ is the per-rank body of
the JAX package's `shard_map` over that axis, called on every rank of the
group with the rank's own row block; the collectives between ranks live
in parallel/comm.py.

The device is explicit: `make_mesh("cuda")` puts rank r on the card
LOCAL_RANK % device_count (torchrun's convention), so all ranks of a
one-card machine share cuda:0. On the card the default backend is NCCL,
on the CPU gloo; `backend="gloo"` on the card must be asked for, and
then parallel/comm.py stages every collective through host memory.
Nothing falls back by itself: a card that is missing, or an NCCL group
that cannot start, raises.

A process that was not started as one of several ranks (no torchrun or
JAX-style environment, parallel/multihost.py) is a mesh of one rank: its
group is a world of one over an in-process store, and every collective
still runs through it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

ROW_AXIS = "dp"

#: how long a collective waits for the other ranks before it fails
DEFAULT_TIMEOUT = timedelta(minutes=10)


@dataclass(frozen=True)
class Mesh:
    """One rank's view of a row mesh: the process group, this rank's
    index in it, the group's size, the device this rank computes on and
    the group's backend."""

    group: object
    rank: int
    size: int
    device: torch.device
    backend: str

    @property
    def staged(self) -> bool:
        """gloo cannot gather or exchange CUDA tensors: its collectives
        go through host copies (parallel/comm.py)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def global_rank(self, rank: int) -> int:
        """The world rank of this group's `rank`."""
        return dist.get_global_rank(self.group, rank)


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda":
        count = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if count == 0:
            raise RuntimeError("make_mesh: no usable CUDA device; pass "
                               "device='cpu' to run on the CPU")
        if device.index is None:
            local = int(os.environ.get("LOCAL_RANK", "0"))
            device = torch.device("cuda", local % count)
    elif device.type != "cpu":
        raise ValueError(f"make_mesh: device must be cuda[:N] or cpu, got "
                         f"{device}")
    return device


def make_mesh(device="cuda", backend: Optional[str] = None,
              timeout: timedelta = DEFAULT_TIMEOUT) -> Mesh:
    """The mesh over every rank of the job, on `device`.

    Starts torch.distributed first if it is not running: from the
    environment of a multi-process launch (parallel/multihost.py), else
    as a world of one. `backend` defaults to "nccl" on the card and
    "gloo" on the CPU; a backend other than the world's gets a group of
    its own over the same ranks."""
    from gp_ss_ak_torch.parallel import multihost

    device = _device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        if not multihost.initialize(backend=backend, timeout=timeout):
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1, timeout=timeout)
    group = dist.group.WORLD
    if dist.get_backend(group) != backend:
        group = dist.new_group(backend=backend, timeout=timeout)
    return Mesh(group, dist.get_rank(group), dist.get_world_size(group),
                device, backend)


def sub_mesh(mesh: Mesh, group) -> Mesh:
    """The mesh over `group`, a subgroup of `mesh`'s ranks that holds
    this rank, on the same device and backend."""
    return Mesh(group, dist.get_rank(group), dist.get_world_size(group),
                mesh.device, mesh.backend)


def pad_rows(n: int, n_devices: int, block: int) -> int:
    """Rows must tile evenly into (ranks x blocks); pad with identity
    rows (unit diagonal, zero elsewhere, zero target) which leave the
    Cholesky, logdet and solves of A = K + sn2 I unchanged."""
    q = n_devices * block
    return ((n + q - 1) // q) * q


def row_sharding(mesh: Mesh, A: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous row block of A (its first axis divisible
    by the mesh size), on the mesh's device."""
    n_local = A.shape[0] // mesh.size
    if n_local * mesh.size != A.shape[0]:
        raise ValueError(f"row_sharding: {A.shape[0]} rows do not split "
                         f"over {mesh.size} ranks")
    return A[mesh.rank * n_local:(mesh.rank + 1) * n_local].to(mesh.device)


def replicated(mesh: Mesh, A) -> torch.Tensor:
    """A on the mesh's device, the same on every rank."""
    return torch.as_tensor(A, device=mesh.device)
