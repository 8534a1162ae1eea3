"""Data prep: text IO + the three standardization schemes."""

from gp_ss_ak_torch.data.io import read_data, write_data, write_predictions
from gp_ss_ak_torch.data.standardize import (
    MODE_MEANSTD,
    MODE_SYMMETRIC,
    MODE_ZERO_ONE,
    Statistics,
    apply,
    compute_statistics,
    prepare,
    unapply_var,
    unapply_x,
    unapply_y,
)

__all__ = [
    "read_data",
    "write_data",
    "write_predictions",
    "Statistics",
    "compute_statistics",
    "prepare",
    "apply",
    "unapply_x",
    "unapply_y",
    "unapply_var",
    "MODE_MEANSTD",
    "MODE_SYMMETRIC",
    "MODE_ZERO_ONE",
]
