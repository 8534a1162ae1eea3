"""ExpAns — the anisotropic exponential kernel (the "AK" in GP_SS_AK).

k(x, y) = sigma^2 * exp(-sqrt(D2)),   D2 = ||M x - M y||^2,
M = R(alphaX, alphaY, alphaZ) diag(iwx, iwy, iwz[, iwR...]) R^T

Both point sets are mapped through M before the Euclidean expansion,
as the reference does (Kern_ExpAnisotropic::computeK Kernel.cpp:856-882
via MahaDist Kernel.cpp:1425-1432). Eight parameters in reference order
with reference inits (Kernel.cpp:737-773); 3-D inputs ignore
InversewidthR, 4-D adds the rock-type dimension, d < 3 is zero-padded
to 3.
"""

from __future__ import annotations

import math

import torch

from gp_ss_ak_torch.kernels.base import Kernel, Params
from gp_ss_ak_torch.kernels.distance import (
    anisotropic_metric,
    pad_to_3d,
    safe_sqrt,
    sq_mahalanobis,
)


class ExpAns(Kernel):
    name = "ExpAns"
    param_suffix = "ExpAns"
    param_names = (
        "AngleX",
        "inverseWidthx",
        "AngleY",
        "inverseWidthy",
        "AngleZ",
        "inverseWidthz",
        "Sigma",
        "inversewidthR",
    )
    # Kernel.cpp:763-773
    init_values = (
        math.pi / 3.1,
        1.5,
        math.pi / 3.1,
        1.5,
        math.pi / 3.1,
        1.3,
        0.9,
        0.6,
    )
    # model files use the reference's exact (mixed-case) names
    _file_names = (
        "AngleX_ExpAns",
        "inverseWidthx_ExpAns",
        "AngleY_ExpAns",
        "inverseWidthy_ExpAns",
        "AngleZ_ExpAns",
        "inverseWidthz_ExpAns",
        "Sigma_ExpAns",
        "InversewidthR_ExpAns",
    )

    def file_param_names(self):
        return self._file_names

    def metric(self, params: Params, input_dim: int) -> torch.Tensor:
        return anisotropic_metric(params, input_dim)

    def matrix(self, params: Params, X1, X2, same: bool = False):
        X1p = pad_to_3d(X1)
        X2p = pad_to_3d(X2)
        M = self.metric(params, X1p.shape[-1])
        d2 = sq_mahalanobis(X1p, X2p, M, same)
        var2 = params["Sigma"] * params["Sigma"]
        return var2 * torch.exp(-safe_sqrt(d2))

    def diag(self, params: Params, X):
        var2 = params["Sigma"] * params["Sigma"]
        return torch.ones(X.shape[0], dtype=X.dtype, device=X.device) * var2
