"""Multi-process start-up and the two-level (chains x rows) mesh.

Port of gp_ss_ak_tpu/parallel/multihost.py. `initialize` starts
torch.distributed from the environment of a multi-process launch: the
JAX package's names (COORDINATOR_ADDRESS = host:port, NUM_PROCESSES,
PROCESS_ID) or torchrun's (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK);
without either it does nothing, as the JAX function does in a single
process. `launch_local` makes such a launch on this machine.

Sharding guidance, as in the JAX package: keep the kernel row axis
inside a host, so that the block Cholesky's per-step all-gathers ride
NVLink, and put independent work (sampler chains, ensemble members) on
the axis across hosts, where only rare, small reductions travel.
"""

from __future__ import annotations

import os
import socket
import subprocess
import time
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


#: launches `launch_local` makes in all when the port it chose was taken
#: before rank 0 could bind it (under a loaded test run two launches in
#: a row have lost their port)
LAUNCH_ATTEMPTS = 5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_local(argv, world: int, workdir: str, timeout: float,
                 env: Optional[dict] = None, cwd: Optional[str] = None,
                 poll_s: float = 0.05) -> float:
    """Run `world` processes of `argv` on this machine as the ranks of
    one job: each gets torchrun's variables (MASTER_ADDR and a free
    MASTER_PORT on localhost, WORLD_SIZE, LOCAL_WORLD_SIZE, RANK,
    LOCAL_RANK) on top of `env` (default os.environ), and writes its
    output to workdir/rank<r>.log. The first rank to fail, or a run past
    `timeout` seconds, stops them all and raises RuntimeError with the
    end of every rank's log. The port is free when chosen, but a
    process of this machine may take it before rank 0 binds it (the
    ranks take seconds to start): a launch that fails so (EADDRINUSE in
    a rank's log) starts again on another port, up to LAUNCH_ATTEMPTS
    launches in all. Returns the last launch's wall seconds."""
    for attempt in range(1, LAUNCH_ATTEMPTS + 1):
        wall, failed, tails = _launch_once(argv, world, workdir, timeout,
                                           env, cwd, poll_s)
        if failed is None:
            return wall
        if attempt == LAUNCH_ATTEMPTS or "EADDRINUSE" not in tails:
            raise RuntimeError(f"{world} local ranks of {argv[1:]}: rank "
                               f"{failed} failed\n" + tails)


def _launch_once(argv, world, workdir, timeout, env, cwd, poll_s):
    """One launch of launch_local: (wall seconds, the failed rank or
    "timeout" or None, the end of every rank's log if one failed)."""
    base = dict(os.environ if env is None else env, MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(_free_port()), WORLD_SIZE=str(world),
                LOCAL_WORLD_SIZE=str(world))
    os.makedirs(workdir, exist_ok=True)
    logs = [os.path.join(workdir, f"rank{r}.log") for r in range(world)]
    t0 = time.perf_counter()
    procs = []
    for r in range(world):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                argv, stdout=log, stderr=subprocess.STDOUT, cwd=cwd,
                env=dict(base, RANK=str(r), LOCAL_RANK=str(r))))
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            failed = next((r for r, p in enumerate(procs)
                           if p.poll() not in (None, 0)), None)
            if failed is not None:
                break
            if time.perf_counter() - t0 > timeout:
                failed = "timeout"
                break
            time.sleep(poll_s)
        else:
            failed = next((r for r, p in enumerate(procs)
                           if p.returncode != 0), None)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    wall = time.perf_counter() - t0
    tails = ""
    if failed is not None:
        for r, path in enumerate(logs):
            with open(path) as f:
                tails += f"--- rank {r}\n{f.read()[-4000:]}"
    return wall, failed, tails


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
                   backend: Optional[str] = None,
                   n_ranks: Optional[int] = None
                   ) -> Optional[TwoLevelMesh]:
    """(chains, rows) mesh over the first `n_ranks` ranks of the job
    (default every rank): consecutive groups of `rows_per_host` ranks
    (default torchrun's LOCAL_WORLD_SIZE, else all `n_ranks`) split each
    chain's rows; rank c * rows + i is row block i of chain c. Every
    rank of the world creates every subgroup, as torch.distributed
    requires; a rank past the first `n_ranks` gets None (the JAX dry run
    builds its two-level mesh on a prefix of the devices the same way,
    __graft_entry__.py:138-147)."""
    world = make_mesh(device, backend)
    n = world.size if n_ranks is None else n_ranks
    if not 0 < n <= world.size:
        raise ValueError(f"two_level_mesh: {n} ranks of a world of "
                         f"{world.size}")
    r = rows_per_host or int(os.environ.get("LOCAL_WORLD_SIZE", n))
    if n % r:
        raise ValueError(f"two_level_mesh: {n} ranks do not split "
                         f"into rows of {r}")
    n_chains = n // r
    ranks = [world.global_rank(i) for i in range(n)]
    rows = chains = None
    for c in range(n_chains):
        g = dist.new_group(ranks[c * r:(c + 1) * r], backend=world.backend)
        if world.rank // r == c and world.rank < n:
            rows = g
    for i in range(r):
        g = dist.new_group(ranks[i::r], backend=world.backend)
        if world.rank % r == i and world.rank < n:
            chains = g
    if world.rank >= n:
        return None
    return TwoLevelMesh(sub_mesh(world, rows), sub_mesh(world, chains),
                        world.rank // r)
