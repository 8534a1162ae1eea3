"""Isotropic stationary kernels: RBF and Exponential.

- RBF: k = sigma^2 * exp(-0.5 * w * d2), d2 = hyp^-2 ||x-y||^2
  (Kern_RBF::computeK, Kernel.cpp:482-488; params Hayper_Euc_RBF,
  inverseWidth_RBF, Sigma_RBF with inits 0.5/0.9/0.5).
- Exponential: k = sigma^2 * exp(-sqrt(d2)) (Kern_Exponential,
  Kernel.cpp:636-642; params Hayper_Euc_Exp, Sigma_Exp, inits 0.5/0.9).
"""

from __future__ import annotations

import torch

from gp_ss_ak_torch.kernels.base import Kernel, Params
from gp_ss_ak_torch.kernels.distance import safe_sqrt, sq_euclidean


class RBF(Kernel):
    name = "RBF"
    param_suffix = "RBF"
    param_names = ("Hayper_Euc", "inverseWidth", "Sigma")
    init_values = (0.5, 0.9, 0.5)

    def matrix(self, params: Params, X1, X2, same: bool = False):
        d2 = sq_euclidean(X1, X2, params["Hayper_Euc"], same)
        var2 = params["Sigma"] * params["Sigma"]
        return var2 * torch.exp(-0.5 * params["inverseWidth"] * d2)

    def diag(self, params: Params, X):
        var2 = params["Sigma"] * params["Sigma"]
        return torch.ones(X.shape[0], dtype=X.dtype, device=X.device) * var2


class Exponential(Kernel):
    name = "Exp"
    param_suffix = "Exp"
    param_names = ("Hayper_Euc", "Sigma")
    init_values = (0.5, 0.9)

    def matrix(self, params: Params, X1, X2, same: bool = False):
        d2 = sq_euclidean(X1, X2, params["Hayper_Euc"], same)
        var2 = params["Sigma"] * params["Sigma"]
        return var2 * torch.exp(-safe_sqrt(d2))

    def diag(self, params: Params, X):
        var2 = params["Sigma"] * params["Sigma"]
        return torch.ones(X.shape[0], dtype=X.dtype, device=X.device) * var2
