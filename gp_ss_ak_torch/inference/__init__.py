"""Inference: exact (warped-)Gaussian GP regression (gaussian), the warp
families (warping) and their quadrature, the iterative solvers of the
matrix-free engines (iterative), sparse GP regression (sgpr) and
generic Laplace inference (laplace)."""

from gp_ss_ak_torch.inference import (
    iterative,
    laplace,
    likelihoods,
    quadrature,
    sgpr,
    warping,
)
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
    "laplace",
    "sgpr",
    "iterative",
    "likelihoods",
    "warping",
    "quadrature",
]
