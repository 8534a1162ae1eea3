"""Cholesky failure recovery.

Port of gp_ss_ak_tpu/utils/psd.py. The reference's whole
numerical-failure strategy is Chol_fail -> NLML = NaN -> the optimizer
rejects the step (GP_Utils.cpp:884-887, Opt_pars.cpp:748-752); that
protocol stays the default (`ops.chol.cholesky` gives a NaN factor).
This module adds the recovery the reference lacks, for serving paths
where a hard NaN is worse than a slightly regularized posterior: retry
the factorization with a geometrically growing diagonal nugget. The JAX
`lax.while_loop` becomes the first factorization plus up to
`max_attempts` retries, each decided by one NaN check read on the host.
"""

from __future__ import annotations

import torch

from gp_ss_ak_torch.ops.chol import cholesky


def robust_cholesky(A: torch.Tensor, max_attempts: int = 4,
                    initial_rel: float = 1e-8):
    """chol(A + c_k I) with c_0 = 0 and c_k = mean(diag A) * initial_rel
    * 100^(k-1) for k = 1..max_attempts, retrying while the factor
    contains NaNs. Returns (L, nugget used); L is still NaN if every
    attempt failed."""
    scale = torch.mean(torch.diagonal(A))
    L = cholesky(A)
    nug = torch.zeros((), dtype=A.dtype, device=A.device)
    k = 0
    while k < max_attempts and not bool(is_spd_cholesky(L)):
        k += 1
        nug = scale * initial_rel * (100.0 ** (k - 1))
        Ak = A.clone()
        Ak.diagonal().add_(nug)
        L = cholesky(Ak)
        del Ak
    return L, nug


def is_spd_cholesky(L: torch.Tensor) -> torch.Tensor:
    """True if the factorization succeeded (no NaNs anywhere)."""
    return ~torch.any(torch.isnan(L))
