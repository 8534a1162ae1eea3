"""Priors + box reparameterization for Bayesian hyperparameters.

Port of gp_ss_ak_tpu/bayes/priors.py. The reference point-estimates
hypers inside a hard box [1e-4, 6] (Opt_pars.cpp:184-189). The Bayesian
path (BASELINE.json config 4) keeps that box as the support: samplers
run in unconstrained z-space with theta = lb + (ub - lb) * sigmoid(z)
and the log-Jacobian added to the target, so HMC/NUTS never step
outside the region where the optimizers live.

Every function takes one point (p,) or a batch of chains (C, p) and
reduces over the last axis only, so a log posterior gives (C,) values.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from gp_ss_ak_torch.optim.lbfgsb import DEFAULT_LOWER, DEFAULT_UPPER


class BoxTransform(NamedTuple):
    lower: torch.Tensor
    upper: torch.Tensor

    def forward(self, z):
        """z (unconstrained) -> theta in (lower, upper)."""
        return self.lower + (self.upper - self.lower) * torch.sigmoid(z)

    def inverse(self, theta):
        u = (theta - self.lower) / (self.upper - self.lower)
        u = torch.clamp(u, 1e-7, 1.0 - 1e-7)
        return torch.log(u) - torch.log1p(-u)

    def log_det_jacobian(self, z):
        # d theta/d z = (ub - lb) * sigmoid(z) * (1 - sigmoid(z))
        return torch.sum(torch.log(self.upper - self.lower)
                         + F.logsigmoid(z) + F.logsigmoid(-z), dim=-1)


def default_box(p: int, dtype=torch.float64, device="cpu") -> BoxTransform:
    return BoxTransform(
        torch.full((p,), DEFAULT_LOWER, dtype=dtype, device=device),
        torch.full((p,), DEFAULT_UPPER, dtype=dtype, device=device),
    )


def uniform_box_log_prior(theta, box: BoxTransform):
    """Flat prior over the box (constant; zero inside)."""
    return theta.new_zeros(theta.shape[:-1])


def lognormal_log_prior(theta, mu=0.0, sigma=1.0):
    """Independent log-normal on every hyper — a weakly-informative
    choice for scales/widths."""
    lt = torch.log(theta)
    return torch.sum(-0.5 * ((lt - mu) / sigma) ** 2 - lt, dim=-1)


def make_log_posterior(nlml_flat, box: BoxTransform, log_prior=None):
    """Unconstrained-space target: z -> log p(z | data).

    nlml_flat: flat theta (C, p) -> NLML (C,), e.g. optim.api's
    `batched_nlml_fn` on the data of every chain.
    """
    log_prior = log_prior or (lambda t: uniform_box_log_prior(t, box))

    def log_post(z):
        theta = box.forward(z)
        return (-nlml_flat(theta) + log_prior(theta)
                + box.log_det_jacobian(z))

    return log_post
