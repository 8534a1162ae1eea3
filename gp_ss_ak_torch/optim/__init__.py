"""Optimization: the host optimizers (bound-constrained L-BFGS, dense
BFGS, SCG; numpy-only copies of gp_ss_ak_tpu/optim), the training
entry point `fit` over the dense and matrix-free engines (the latter
cold or warm-started), and the matrix-free engine's model check."""

from gp_ss_ak_torch.optim.api import (
    fit,
    flat_nlml_fn,
    make_value_and_grad,
    resolve_engine,
)
from gp_ss_ak_torch.optim.bfgs import DenseBFGS
from gp_ss_ak_torch.optim.iterative_fit import (
    DENSE_MAX_N,
    make_iterative_value_and_grad,
    supports_iterative,
)
from gp_ss_ak_torch.optim.lbfgsb import (
    DEFAULT_LOWER,
    DEFAULT_UPPER,
    LBFGSB,
    OptResult,
)
from gp_ss_ak_torch.optim.scg import SCG
from gp_ss_ak_torch.optim.segmented import make_segmented_value_and_grad

__all__ = [
    "fit",
    "DenseBFGS",
    "flat_nlml_fn",
    "make_value_and_grad",
    "resolve_engine",
    "make_iterative_value_and_grad",
    "make_segmented_value_and_grad",
    "supports_iterative",
    "DENSE_MAX_N",
    "LBFGSB",
    "SCG",
    "OptResult",
    "DEFAULT_LOWER",
    "DEFAULT_UPPER",
]
