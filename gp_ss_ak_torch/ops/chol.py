"""Cholesky with the reference's failure protocol.

A failed factorization must surface as NaN, not as an exception: the
objective then becomes NaN and the optimizers reject the step (the
reference's Chol_fail -> NaN protocol, GP_Utils.cpp:884-915; the JAX
package gets it from jnp.linalg.cholesky, gp_ss_ak_tpu/ops/chol.py).
`torch.linalg.cholesky` raises instead, so this uses `cholesky_ex`
(cuSOLVER potrf on the GPU, LAPACK on the CPU) and fills the factor
with NaN where `info > 0` — on the device, without a host sync. The
failed factor has the same form as JAX's: NaN on and below the
diagonal, zeros above.

The TPU's blocked Cholesky (gp_ss_ak_tpu/ops/chol.py:45-77) is not
ported: it was an opt-in MXU experiment; potrf is its counterpart.
"""

from __future__ import annotations

import torch


def cholesky(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of A; NaN lower triangle if A is not
    positive definite. Under autograd (A requires grad) the NaN fill is
    out of place, since potrf's backward reads its own output; elsewhere
    it reuses the factor's buffer."""
    L, info = torch.linalg.cholesky_ex(A)
    bad = (info != 0)[..., None, None]
    if torch.is_grad_enabled() and A.requires_grad:
        return L.masked_fill(bad, float("nan")).tril()
    return L.masked_fill_(bad, float("nan")).tril_()
