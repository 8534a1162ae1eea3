"""Bias and White-noise kernels.

- Bias: k = sigma_b everywhere (NOT squared — Kern_Bias::computeK fills
  K with Sigma_Bias, Kernel.cpp:362-367; init 0.2, Kernel.cpp:317-319).
- White: k = sigma_w on the diagonal, only when the two point sets are
  the same (the static ``same`` flag, Kernel.cpp:256-263). Init 0.10
  (Kernel.cpp:214-217).
"""

from __future__ import annotations

import torch

from gp_ss_ak_torch.kernels.base import Kernel, Params


class Bias(Kernel):
    name = "Bias"
    param_suffix = "Bias"
    param_names = ("Sigma",)
    init_values = (0.2,)

    def matrix(self, params: Params, X1, X2, same: bool = False):
        shape = (X1.shape[0], X2.shape[0])
        return params["Sigma"].to(X1.dtype).expand(shape)

    def diag(self, params: Params, X):
        return params["Sigma"].to(X.dtype).expand(X.shape[0])


class White(Kernel):
    name = "White Noise"  # written name, Kernel.cpp:208
    param_suffix = "White"
    param_names = ("Sigma",)
    init_values = (0.10,)

    def matrix(self, params: Params, X1, X2, same: bool = False):
        shape = (X1.shape[0], X2.shape[0])
        if not same:
            return torch.zeros(shape, dtype=X1.dtype, device=X1.device)
        eye = torch.eye(*shape, dtype=X1.dtype, device=X1.device)
        return params["Sigma"] * eye

    def diag(self, params: Params, X):
        return params["Sigma"].to(X.dtype).expand(X.shape[0])
