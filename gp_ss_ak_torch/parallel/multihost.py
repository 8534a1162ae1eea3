"""Multi-process start-up and the two-level (chains x rows) mesh.

Port of gp_ss_ak_tpu/parallel/multihost.py. `initialize` starts
torch.distributed from the environment of a multi-process launch: the
JAX package's names (COORDINATOR_ADDRESS = host:port, NUM_PROCESSES,
PROCESS_ID) or torchrun's (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK);
without either it does nothing, as the JAX function does in a single
process.

Sharding guidance, as in the JAX package: keep the kernel row axis
inside a host, so that the block Cholesky's per-step all-gathers ride
NVLink, and put independent work (sampler chains, ensemble members) on
the axis across hosts, where only rare, small reductions travel.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from gp_ss_ak_torch.parallel.mesh import (
    DEFAULT_TIMEOUT,
    Mesh,
    make_mesh,
    sub_mesh,
)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               timeout=DEFAULT_TIMEOUT) -> bool:
    """init_process_group from the arguments or the environment; False
    (nothing started) when neither names a coordinator. `backend`
    defaults to NCCL where a card is visible, else gloo."""
    env = os.environ
    addr = coordinator_address or env.get("COORDINATOR_ADDRESS")
    if addr is not None:
        # NOTE: `process_id or env[...]` would be wrong: process 0 is
        # falsy and must not fall through to the variable
        if num_processes is None:
            num_processes = int(env["NUM_PROCESSES"])
        if process_id is None:
            process_id = int(env["PROCESS_ID"])
    elif "MASTER_ADDR" in env and "MASTER_PORT" in env:
        addr = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        if num_processes is None:
            num_processes = int(env["WORLD_SIZE"])
        if process_id is None:
            process_id = int(env["RANK"])
    else:
        return False
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(backend, init_method=f"tcp://{addr}",
                            world_size=num_processes, rank=process_id,
                            timeout=timeout)
    return True


@dataclass(frozen=True)
class TwoLevelMesh:
    """A (chains, rows) grid of ranks: `rows` is this rank's row mesh
    (its chain's ranks, which split the data), `chains` the mesh of the
    ranks that hold the same row block in every chain, and `chain` this
    rank's chain index."""

    rows: Mesh
    chains: Mesh
    chain: int

    @property
    def n_chains(self) -> int:
        return self.chains.size


def two_level_mesh(rows_per_host: Optional[int] = None, device="cuda",
                   backend: Optional[str] = None) -> TwoLevelMesh:
    """(chains, rows) mesh over every rank of the job: consecutive
    groups of `rows_per_host` ranks (default torchrun's LOCAL_WORLD_SIZE,
    else the whole world) split each chain's rows; rank c * rows + i is
    row block i of chain c. Every rank creates every subgroup, as
    torch.distributed requires."""
    world = make_mesh(device, backend)
    r = rows_per_host or int(os.environ.get("LOCAL_WORLD_SIZE",
                                            world.size))
    if world.size % r:
        raise ValueError(f"two_level_mesh: {world.size} ranks do not split "
                         f"into rows of {r}")
    n_chains = world.size // r
    ranks = [world.global_rank(i) for i in range(world.size)]
    rows = chains = None
    for c in range(n_chains):
        g = dist.new_group(ranks[c * r:(c + 1) * r], backend=world.backend)
        if world.rank // r == c:
            rows = g
    for i in range(r):
        g = dist.new_group(ranks[i::r], backend=world.backend)
        if world.rank % r == i:
            chains = g
    return TwoLevelMesh(sub_mesh(world, rows), sub_mesh(world, chains),
                        world.rank // r)
