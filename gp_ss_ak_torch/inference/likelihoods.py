"""Likelihoods: Gaussian and warped Gaussian.

Port of gp_ss_ak_tpu/inference/likelihoods.py. Conventions copied from
the reference's behavior (not its code):

- Gaussian: the single likelihood hyper IS sn2 (the noise *variance*,
  used directly — the exp(2 theta) form is commented out at
  GP_Utils.cpp:405-406). Default init 0.016 (GP_Utils.cpp:43).
- WarpGauss: targets are warped through g(.) (inference/warping.py),
  the Gaussian noise acts on g(y) with sn2 = exp(2 * theta[-1])
  (GP_Utils.cpp:421), and the log-density gains + log g'(y)
  (GP_Utils.cpp:424).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from gp_ss_ak_torch.inference import warping

LIK_GAUSSIAN = 0  # enum values as written in model files (likelihood=<int>)
LIK_WARPGAUSS = 1


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
    def log_prob(hypers, y, f):
        sn2 = hypers[0]
        r = y - f
        return -(r * r) / (2.0 * sn2) - 0.5 * torch.log(2.0 * math.pi * sn2)

    @staticmethod
    def effective_target(hypers, y):
        """The value the conjugate Gaussian algebra regresses on."""
        return y, torch.zeros_like(y)  # (g(y), log g'(y)=0)


@dataclass(frozen=True)
class WarpedGaussian:
    """Gaussian on g(y); hypers = [3m warp hypers..., noise theta].

    sn2 = exp(2 * hypers[-1]) (GP_Utils.cpp:421). The warp family needs
    max(y_train) for its rbf-centre clamp.
    """

    family: str = warping.TANH1
    n_triplets: int = 1
    kind: int = LIK_WARPGAUSS

    @property
    def n_hypers(self):
        return 3 * self.n_triplets + 1

    def default_hypers(self, dtype: torch.dtype, device: torch.device):
        return torch.full((self.n_hypers,), 0.016, dtype=dtype,
                          device=device)

    @staticmethod
    def noise_variance(hypers):
        return torch.exp(2.0 * hypers[-1])

    def warp_hypers(self, hypers):
        return hypers[:-1]

    def effective_target(self, hypers, y, y_train_max=None):
        """(g(y), log g'(y)); the rbf clamp takes max(y) unless
        `y_train_max` is given."""
        ymax = torch.max(y) if y_train_max is None else y_train_max
        return warping.warp(self.family, self.warp_hypers(hypers), y, ymax)

    def log_prob(self, hypers, y, f, y_train_max=None):
        sn2 = self.noise_variance(hypers)
        gy, lgpy = self.effective_target(hypers, y, y_train_max)
        r = gy - f
        return (-(r * r) / (2.0 * sn2) - 0.5 * torch.log(2.0 * math.pi * sn2)
                + lgpy)


def make_likelihood(kind: int, warp_family: str = warping.TANH1,
                    n_triplets: int = 1):
    if kind == LIK_GAUSSIAN:
        return Gaussian()
    if kind == LIK_WARPGAUSS:
        return WarpedGaussian(warp_family, n_triplets)
    raise ValueError(f"unknown likelihood kind {kind}")
