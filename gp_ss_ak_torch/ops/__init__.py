"""Device ops: the fused Gram kernel (K1), its dispatch and closed-form
backwards (square and cross), Cholesky, and the streamed Gram matmat
(K3)."""

from gp_ss_ak_torch.ops.chol import cholesky
from gp_ss_ak_torch.ops.fused import (
    fused_expans_bias_A,
    fused_expans_bias_cross,
    mapped_points,
    maybe_fused_A,
    maybe_fused_cross,
)
from gp_ss_ak_torch.ops.matvec import (
    operator_arrays,
    streamed_matmat,
    streamed_matmat_plain,
)
from gp_ss_ak_torch.ops.pairwise import (
    expans_bias_gram,
    expans_bias_gram_plain,
)

__all__ = [
    "cholesky",
    "expans_bias_gram",
    "expans_bias_gram_plain",
    "fused_expans_bias_A",
    "fused_expans_bias_cross",
    "mapped_points",
    "maybe_fused_A",
    "maybe_fused_cross",
    "operator_arrays",
    "streamed_matmat",
    "streamed_matmat_plain",
]
