"""The collectives of the mesh engines, in one place.

Counterparts of what the JAX package's shard_map bodies call:

  psum / pmax / pmin  lax.psum, lax.pmax, lax.pmin (an all-reduce);
  broadcast           the masked psum of pchol._bcast_from_owner
                      (gp_ss_ak_tpu/parallel/pchol.py:46-50): the
                      owner's block reaches every rank;
  all_gather          lax.all_gather(tiled=True) over the row axis;
  ring_shift          lax.ppermute around the ring (ring.py:41-43): each
                      rank sends its block to the next and receives the
                      previous rank's.

Every call runs its collective through the mesh's group, a mesh of one
rank included: there is no branch that skips it at size 1. The results
are new tensors; the caller's are never written. Collectives sit outside
autograd (the mesh engines reduce gradients themselves).

Host staging: gloo all-reduces and broadcasts CUDA tensors but neither
gathers nor exchanges them, so when the caller chose gloo for a mesh on
the card (`make_mesh(..., backend="gloo")`, several ranks sharing one
card) every collective goes through a host copy, taken here and nowhere
else. NCCL and gloo on the CPU work on the tensors in place.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from gp_ss_ak_torch.parallel.mesh import Mesh


def _buffer(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """A private contiguous copy of t for a collective to write into."""
    t = t.detach()
    return t.to("cpu", copy=True) if mesh.staged else t.clone(
        memory_format=torch.contiguous_format)


def _back(mesh: Mesh, buf: torch.Tensor) -> torch.Tensor:
    return buf.to(mesh.device) if mesh.staged else buf


def _all_reduce(mesh: Mesh, t: torch.Tensor, op) -> torch.Tensor:
    buf = _buffer(mesh, t)
    dist.all_reduce(buf, op=op, group=mesh.group)
    return _back(mesh, buf)


def psum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The sum of t over the ranks."""
    return _all_reduce(mesh, t, dist.ReduceOp.SUM)


def pmax(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    return _all_reduce(mesh, t, dist.ReduceOp.MAX)


def pmin(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    return _all_reduce(mesh, t, dist.ReduceOp.MIN)


def any_rank(mesh: Mesh, flag) -> bool:
    """True on every rank when `flag` (a bool tensor or Python bool)
    holds on any: one host read."""
    t = torch.as_tensor(flag, device=mesh.device).any().to(torch.int32)
    return bool(pmax(mesh, t))


def broadcast(mesh: Mesh, t: torch.Tensor, owner: int) -> torch.Tensor:
    """The owner rank's t on every rank; the other ranks pass any tensor
    of the same shape and dtype."""
    buf = _buffer(mesh, t)
    dist.broadcast(buf, src=mesh.global_rank(owner), group=mesh.group)
    return _back(mesh, buf)


def all_gather(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The ranks' t stacked along the first axis in rank order
    (lax.all_gather(tiled=True)): (size * n, ...)."""
    buf = _buffer(mesh, t)
    out = buf.new_empty((mesh.size * buf.shape[0], *buf.shape[1:]))
    dist.all_gather(list(out.chunk(mesh.size)), buf, group=mesh.group)
    return _back(mesh, out)


def ring_shift(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The previous rank's t (each rank sends its own to the next one),
    as one all-to-all with a single non-empty split each way."""
    buf = _buffer(mesh, t).reshape(-1)
    nxt, prv = (mesh.rank + 1) % mesh.size, (mesh.rank - 1) % mesh.size
    send = [0] * mesh.size
    recv = [0] * mesh.size
    send[nxt] = recv[prv] = buf.numel()
    out = torch.empty_like(buf)
    dist.all_to_all_single(out, buf, recv, send, group=mesh.group)
    return _back(mesh, out.reshape(t.shape))


def block_bounds(mesh: Mesh, count: int, rank: int = None):
    """[lo, hi) of `rank`'s (default this rank's) contiguous share of
    `count` independent items (ensemble members, sampler chains): shares
    differ by at most one, and every rank gets one when count >= size."""
    r = mesh.rank if rank is None else rank
    return (r * count) // mesh.size, ((r + 1) * count) // mesh.size


def all_gather_blocks(mesh: Mesh, t: torch.Tensor, count: int) -> torch.Tensor:
    """The ranks' `block_bounds` shares t (first axis) of `count` items,
    joined in rank order: each share padded to the largest, gathered,
    then trimmed."""
    m = -(-count // mesh.size)
    pad = t.new_zeros((m - t.shape[0], *t.shape[1:]))
    out = all_gather(mesh, torch.cat([t, pad]))
    parts = []
    for r in range(mesh.size):
        lo, hi = block_bounds(mesh, count, r)
        parts.append(out[r * m:r * m + hi - lo])
    return torch.cat(parts)
