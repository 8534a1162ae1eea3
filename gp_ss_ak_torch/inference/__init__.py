"""Inference: exact (warped-)Gaussian GP regression (gaussian), the warp
families (warping) and their quadrature, and the iterative solvers of
the matrix-free engines (inference.iterative)."""

from gp_ss_ak_torch.inference import likelihoods, quadrature, warping
from gp_ss_ak_torch.inference.gaussian import (
    Posterior,
    factorize,
    nlml,
    posterior_mean,
    posterior_mean_var,
    predict,
    warped_predictive_mix,
)
from gp_ss_ak_torch.inference.likelihoods import (
    LIK_GAUSSIAN,
    LIK_WARPGAUSS,
    Gaussian,
    WarpedGaussian,
    make_likelihood,
)

__all__ = [
    "Posterior",
    "factorize",
    "nlml",
    "posterior_mean",
    "posterior_mean_var",
    "predict",
    "warped_predictive_mix",
    "Gaussian",
    "WarpedGaussian",
    "make_likelihood",
    "LIK_GAUSSIAN",
    "LIK_WARPGAUSS",
    "likelihoods",
    "warping",
    "quadrature",
]
