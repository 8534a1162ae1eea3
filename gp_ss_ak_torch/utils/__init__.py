"""Utilities: structured fit logging, the jitter-retry factorization,
checkpoints, profiling and numerical debugging (port of
gp_ss_ak_tpu/utils; its shard_map plumbing, vma.py, is not needed)."""

from gp_ss_ak_torch.utils.logging import FitLogger
from gp_ss_ak_torch.utils.profiling import (
    achieved_tflops,
    chain_timeit,
    cholesky_flops,
    gram_flops,
    solve_flops,
    timeit_fn,
    trace,
)
from gp_ss_ak_torch.utils.psd import is_spd_cholesky, robust_cholesky

__all__ = [
    "FitLogger",
    "robust_cholesky",
    "is_spd_cholesky",
    "trace",
    "chain_timeit",
    "timeit_fn",
    "gram_flops",
    "cholesky_flops",
    "solve_flops",
    "achieved_tflops",
]
