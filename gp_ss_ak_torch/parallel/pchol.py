"""Distributed block Cholesky + triangular solves over a row mesh.

Port of gp_ss_ak_tpu/parallel/pchol.py. Layout: the padded N x N matrix
is split by CONTIGUOUS ROW BLOCKS over the ranks; every function here is
the per-rank body, called on every rank of the mesh with its own
(n_local, N) block.

Right-looking algorithm per block column j (block size nb):
  1. the owner broadcasts the diagonal block A[j, j], and every rank
     factors the small nb x nb block itself (cuSOLVER potrf through
     `cholesky_ex`; a block that is not positive definite gives NaN, so
     the NLML and its gradient become NaN and the optimizer rejects the
     step: nothing raises);
  2. each rank right-solves the rows of its panel below the block
     against D^T;
  3. one all-gather assembles the full column block L[:, j];
  4. the trailing update A -= L_panel L_col^T is a local matrix product,
     and the panel overwrites A's column block, so L materializes in the
     buffer of A.

The substitutions follow the same pattern: the owner broadcasts the
diagonal block together with the right-hand side's rows (one broadcast
a step), and local products update the rows still to solve; the
backward sweep also needs the owner's ROW block of L, sent in the same
broadcast.

Deliberate difference: the JAX package needs static shapes inside
`fori_loop`, so it computes every update over all rows and columns and
masks the half it does not want (`jnp.where(colmask, upd, 0)`). Here the
updates are sliced to the rows and columns they change (rows below the
block, columns right of it; in the backward sweep, rows above it and
only the columns of L it needs), with the same results to round-off.
Matrix products run in full float32 (no TF32), as the JAX package forces
HIGHEST precision.
"""

from __future__ import annotations

import torch

from gp_ss_ak_torch.kernels.distance import highest_precision
from gp_ss_ak_torch.ops.chol import cholesky
from gp_ss_ak_torch.parallel import comm
from gp_ss_ak_torch.parallel.mesh import Mesh


def _check(n_local: int, N: int, nb: int, mesh: Mesh) -> None:
    if N % nb or n_local % nb or n_local * mesh.size != N:
        raise ValueError(f"row block ({n_local}, {N}) does not tile into "
                         f"{mesh.size} ranks x blocks of {nb} (pad with "
                         f"parallel.mesh.pad_rows)")


def _rows(jb: int, nb: int, g0: int, n_local: int):
    """Local row bounds of block column jb: rows [lo, hi) lie in the
    diagonal block, rows [hi, n_local) below it."""
    lo = min(max(jb - g0, 0), n_local)
    hi = min(max(jb + nb - g0, 0), n_local)
    return lo, hi


def _owner_rows(mesh: Mesh, jb: int, nb: int, n_local: int, *parts):
    """The owner's rows [jb, jb + nb) of the column-joined `parts`
    (row-split tensors, or column slices of them), on every rank."""
    owner = jb // n_local
    if mesh.rank == owner:
        off = jb - owner * n_local
        blk = torch.cat([p[off:off + nb] for p in parts], dim=1)
    else:
        blk = parts[0].new_empty((nb, sum(p.shape[1] for p in parts)))
    return comm.broadcast(mesh, blk, owner)


def block_cholesky_local(A_local: torch.Tensor, nb: int, mesh: Mesh):
    """Factor the row-split A into L (lower, in A's layout). Returns
    (L_local, half_logdet) with half_logdet the same on every rank.
    Requires N % nb == 0 and n_local % nb == 0 (pad upstream,
    parallel/mesh.py pad_rows)."""
    n_local, N = A_local.shape
    _check(n_local, N, nb, mesh)
    g0 = mesh.rank * n_local
    K = A_local.detach().clone()
    with highest_precision():
        for jb in range(0, N, nb):
            D = cholesky(_owner_rows(mesh, jb, nb, n_local,
                                     K[:, jb:jb + nb]))
            lo, hi = _rows(jb, nb, g0, n_local)
            Lp = torch.zeros((n_local, nb), dtype=K.dtype, device=K.device)
            # panel rows below the block: X D^T = C  ->  X = C D^-T
            Lp[hi:] = torch.linalg.solve_triangular(
                D.mT, K[hi:, jb:jb + nb], upper=True, left=False)
            Lp[lo:hi] = D[lo + g0 - jb:hi + g0 - jb]
            Lcol = comm.all_gather(mesh, Lp)                 # (N, nb)
            K[hi:, jb + nb:] -= Lp[hi:] @ Lcol[jb + nb:].mT
            K[:, jb:jb + nb] = Lp
    L = K.tril_(diagonal=g0)
    half_logdet = comm.psum(mesh, torch.sum(torch.log(
        L.diagonal(offset=g0))))
    return L, half_logdet


def tri_solve_lower_local(L_local: torch.Tensor, B_local: torch.Tensor,
                          nb: int, mesh: Mesh) -> torch.Tensor:
    """Forward substitution L Z = B, everything row-split."""
    n_local, N = L_local.shape
    _check(n_local, N, nb, mesh)
    g0 = mesh.rank * n_local
    B = B_local.detach().clone()
    with highest_precision():
        for jb in range(0, N, nb):
            blk = _owner_rows(mesh, jb, nb, n_local,
                              L_local[:, jb:jb + nb], B)
            Z = torch.linalg.solve_triangular(blk[:, :nb], blk[:, nb:],
                                              upper=False)
            lo, hi = _rows(jb, nb, g0, n_local)
            B[hi:] -= L_local[hi:, jb:jb + nb] @ Z
            B[lo:hi] = Z[lo + g0 - jb:hi + g0 - jb]
    return B


def tri_solve_upper_local(L_local: torch.Tensor, B_local: torch.Tensor,
                          nb: int, mesh: Mesh) -> torch.Tensor:
    """Backward substitution L^T Z = B, everything row-split. Each step
    needs the owner's ROW block of L up to the block's last column (the
    columns of L^T that reach the rows above), one broadcast with the
    block's right-hand sides."""
    n_local, N = L_local.shape
    _check(n_local, N, nb, mesh)
    g0 = mesh.rank * n_local
    B = B_local.detach().clone()
    with highest_precision():
        for jb in range(N - nb, -1, -nb):
            blk = _owner_rows(mesh, jb, nb, n_local,
                              L_local[:, :jb + nb], B)
            Lrows, Bj = blk[:, :jb + nb], blk[:, jb + nb:]
            Z = torch.linalg.solve_triangular(Lrows[:, jb:].mT, Bj,
                                              upper=True)
            lo, hi = _rows(jb, nb, g0, n_local)
            # rows above the block: B -= L[jb-block, rows]^T Z
            B[:lo] -= Lrows[:, g0:g0 + lo].mT @ Z
            B[lo:hi] = Z[lo + g0 - jb:hi + g0 - jb]
    return B


def solve_chol_local(L_local, B_local, nb: int, mesh: Mesh):
    """A^-1 B = L^-T (L^-1 B), the distributed `solve_chol`
    (GP_Utils.cpp:841-845 equivalence)."""
    Z = tri_solve_lower_local(L_local, B_local, nb, mesh)
    return tri_solve_upper_local(L_local, Z, nb, mesh)
