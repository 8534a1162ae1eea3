"""Utilities: structured fit logging (port of gp_ss_ak_tpu/utils; the
jitter-retry factorization, profiling and checkpoint helpers are not
ported)."""

from gp_ss_ak_torch.utils.logging import FitLogger

__all__ = ["FitLogger"]
