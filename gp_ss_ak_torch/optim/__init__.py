"""Optimization engines. So far only the capability check of the
matrix-free engine (iterative_fit.supports_iterative), which the
serving path uses; the optimizers arrive with the training slice."""

from gp_ss_ak_torch.optim.iterative_fit import supports_iterative

__all__ = ["supports_iterative"]
