"""Dispatch of the flagship model's Gram builds to the fused kernel.

`maybe_fused_A` recognizes the CLI's flagship model (Sum([ExpAns, Bias])
+ Gaussian noise, gp_ss_ak.cpp:146-190) and builds its A = K + sn2 I
through `ops.pairwise.expans_bias_gram`; `fused_cross_gram` does the
same for the serving cross-covariance. Both return None for any other
kernel, which then takes the generic torch Gram (kernel.matrix).

Unlike the JAX package, which takes its Pallas kernel only on a TPU
above tuned sizes (fused.py:117, gaussian.py:222), the port routes the
flagship model through the wrapper at every size: the wrapper launches
the CUDA kernel for CUDA tensors and runs its plain version for CPU
tensors. Forward only; the closed-form backward (gp_ss_ak_tpu
ops/fused.py:43-58) arrives with the training path.
"""

from __future__ import annotations

import torch

from gp_ss_ak_torch.kernels.anisotropic import ExpAns
from gp_ss_ak_torch.kernels.composite import Sum
from gp_ss_ak_torch.kernels.distance import pad_to_3d
from gp_ss_ak_torch.kernels.simple import Bias
from gp_ss_ak_torch.ops.pairwise import expans_bias_gram


def _is_flagship(kernel) -> bool:
    return (isinstance(kernel, Sum) and len(kernel.children) == 2
            and isinstance(kernel.children[0], ExpAns)
            and isinstance(kernel.children[1], Bias))


def mapped_points(expans: ExpAns, params, X: torch.Tensor) -> torch.Tensor:
    """Recentre X by its OWN mean + metric-map it, so Euclidean distance
    equals the reference's MahaDist (Kernel.cpp:1391-1427)."""
    Xp = pad_to_3d(X)
    c = torch.mean(Xp, dim=0)
    M = expans.metric(params, Xp.shape[-1])
    return (Xp - c) @ M


def maybe_fused_A(kernel, params, sn2, X: torch.Tensor,
                  jitter: float = 0.0):
    """A = K + (sn2 + jitter) I via the fused kernel for the flagship
    model, else None."""
    if not _is_flagship(kernel):
        return None
    expans_params, bias_params = params
    Xm = mapped_points(kernel.children[0], expans_params, X)
    return expans_bias_gram(Xm, expans_params["Sigma"],
                            bias_params["Sigma"], sn2 + jitter)


def fused_cross_gram(kernel, params, X: torch.Tensor, Xstar: torch.Tensor):
    """Fused cross-covariance K(X, X*) for serving, else None. Both sets
    are recentred by their COMBINED mean, as kernel.matrix does
    (distance.py _recentre), not by X's own mean."""
    if not _is_flagship(kernel):
        return None
    expans_params, bias_params = params
    expans = kernel.children[0]
    Xp = pad_to_3d(X)
    Xsp = pad_to_3d(Xstar)
    c = (torch.sum(Xp, dim=0) + torch.sum(Xsp, dim=0)) / (
        Xp.shape[0] + Xsp.shape[0])
    M = expans.metric(expans_params, Xp.shape[-1])
    return expans_bias_gram((Xp - c) @ M, expans_params["Sigma"],
                            bias_params["Sigma"], None, Xm2=(Xsp - c) @ M)
