"""Mesh engines over torch.distributed: the row-split exact GP (block
Cholesky, NLML, gradient, prediction) and the ring's matrix-free one.

Port of gp_ss_ak_tpu/parallel. A mesh is a process group of ranks, one
device each (mesh.py); every function is the per-rank body of the JAX
package's shard_map and is called on every rank with the rank's own row
block (`shard_training_data`). The collectives live in comm.py.
"""

from gp_ss_ak_torch.parallel.fit import fit_distributed, fit_ring
from gp_ss_ak_torch.parallel.mesh import (
    ROW_AXIS,
    Mesh,
    make_mesh,
    pad_rows,
    replicated,
    row_sharding,
)
from gp_ss_ak_torch.parallel.multihost import (
    TwoLevelMesh,
    initialize,
    two_level_mesh,
)
from gp_ss_ak_torch.parallel.nlml import (
    make_dist_nlml_and_grad,
    make_dist_predict,
    make_two_level_nlml_and_grad,
    shard_training_data,
)
from gp_ss_ak_torch.parallel.pchol import (
    block_cholesky_local,
    solve_chol_local,
    tri_solve_lower_local,
    tri_solve_upper_local,
)
from gp_ss_ak_torch.parallel.ring import (
    make_ring_cg_solve,
    make_ring_matvec,
    make_ring_nlml_and_grad,
    make_ring_posterior_mean,
    make_ring_predict,
    make_two_level_ring_nlml_and_grad,
)

__all__ = [
    "ROW_AXIS",
    "Mesh",
    "TwoLevelMesh",
    "make_mesh",
    "initialize",
    "two_level_mesh",
    "pad_rows",
    "row_sharding",
    "replicated",
    "fit_distributed",
    "fit_ring",
    "make_dist_nlml_and_grad",
    "make_ring_nlml_and_grad",
    "make_two_level_nlml_and_grad",
    "make_two_level_ring_nlml_and_grad",
    "make_dist_predict",
    "make_ring_matvec",
    "make_ring_cg_solve",
    "make_ring_posterior_mean",
    "make_ring_predict",
    "shard_training_data",
    "block_cholesky_local",
    "solve_chol_local",
    "tri_solve_lower_local",
    "tri_solve_upper_local",
]
