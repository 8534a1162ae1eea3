"""Likelihoods: the plain Gaussian.

- Gaussian: the single likelihood hyper IS sn2 (the noise *variance*,
  used directly — the exp(2 theta) form is commented out at
  GP_Utils.cpp:405-406). Default init 0.016 (GP_Utils.cpp:43).

The warped Gaussian (gp_ss_ak_tpu/inference/likelihoods.py
WarpedGaussian) needs the warp families and their inverse
(inference/warping.py), which are not ported yet; asking for it raises
NotImplementedError.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

LIK_GAUSSIAN = 0  # enum values as written in model files (likelihood=<int>)
LIK_WARPGAUSS = 1

WARPED_NOT_PORTED = ("WarpedGaussian (likelihood=1) is not ported to "
                     "gp_ss_ak_torch yet: it needs inference/warping.py")


@dataclass(frozen=True)
class Gaussian:
    """iid Gaussian observation noise; hypers = [sn2] (direct value)."""

    n_hypers: int = 1
    kind: int = LIK_GAUSSIAN

    @staticmethod
    def default_hypers(dtype: torch.dtype, device: torch.device):
        # GP_Utils.cpp:43
        return torch.tensor([0.016], dtype=dtype, device=device)

    @staticmethod
    def noise_variance(hypers):
        return hypers[0]

    @staticmethod
    def effective_target(hypers, y):
        """The value the conjugate Gaussian algebra regresses on."""
        return y, torch.zeros_like(y)  # (g(y), log g'(y)=0)


def make_likelihood(kind: int):
    if kind == LIK_GAUSSIAN:
        return Gaussian()
    if kind == LIK_WARPGAUSS:
        raise NotImplementedError(WARPED_NOT_PORTED)
    raise ValueError(f"unknown likelihood kind {kind}")
