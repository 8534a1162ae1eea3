"""Kernel library: ExpAns / RBF / Exp / Bias / White + additive Sum."""

from gp_ss_ak_torch.kernels.anisotropic import ExpAns
from gp_ss_ak_torch.kernels.base import Kernel, Params
from gp_ss_ak_torch.kernels.composite import Sum
from gp_ss_ak_torch.kernels.distance import (
    anisotropic_metric,
    gram_sqdist,
    rotation_matrix_3d,
    safe_sqrt,
    sq_euclidean,
    sq_mahalanobis,
)
from gp_ss_ak_torch.kernels.registry import (
    available_kernels,
    default_train_kernel,
    make_kernel,
)
from gp_ss_ak_torch.kernels.simple import Bias, White
from gp_ss_ak_torch.kernels.stationary import Exponential, RBF

__all__ = [
    "Kernel",
    "Params",
    "ExpAns",
    "RBF",
    "Exponential",
    "Bias",
    "White",
    "Sum",
    "make_kernel",
    "available_kernels",
    "default_train_kernel",
    "sq_euclidean",
    "sq_mahalanobis",
    "gram_sqdist",
    "rotation_matrix_3d",
    "anisotropic_metric",
    "safe_sqrt",
]
