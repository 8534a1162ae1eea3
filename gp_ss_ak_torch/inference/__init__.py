"""Inference: exact Gaussian GP regression (serving path), and the
iterative solvers of the matrix-free server (inference.iterative)."""

from gp_ss_ak_torch.inference.gaussian import (
    Posterior,
    factorize,
    nlml,
    posterior_mean_var,
    predict,
)
from gp_ss_ak_torch.inference.likelihoods import (
    LIK_GAUSSIAN,
    LIK_WARPGAUSS,
    Gaussian,
    make_likelihood,
)

__all__ = [
    "Posterior",
    "factorize",
    "nlml",
    "posterior_mean_var",
    "predict",
    "Gaussian",
    "make_likelihood",
    "LIK_GAUSSIAN",
    "LIK_WARPGAUSS",
]
