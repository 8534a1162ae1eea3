"""Utilities: structured fit logging and the jitter-retry factorization
(port of gp_ss_ak_tpu/utils; the profiling and checkpoint helpers are
not ported)."""

from gp_ss_ak_torch.utils.logging import FitLogger
from gp_ss_ak_torch.utils.psd import is_spd_cholesky, robust_cholesky

__all__ = ["FitLogger", "robust_cholesky", "is_spd_cholesky"]
