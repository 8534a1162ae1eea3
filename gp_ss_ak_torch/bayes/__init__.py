"""Bayesian hyperposteriors: HMC / iterative NUTS + predictive mixing
(port of gp_ss_ak_tpu/bayes, with the same names)."""

from gp_ss_ak_torch.bayes.api import predictive_mixture, sample_hyperposterior
from gp_ss_ak_torch.bayes.diagnostics import (ess_bulk, ess_tail, split_rhat,
                                              summarize)
from gp_ss_ak_torch.bayes.hmc import hmc_sample, nuts_sample
from gp_ss_ak_torch.bayes.priors import (
    BoxTransform,
    default_box,
    lognormal_log_prior,
    make_log_posterior,
    uniform_box_log_prior,
)

__all__ = [
    "sample_hyperposterior",
    "predictive_mixture",
    "hmc_sample",
    "split_rhat",
    "ess_bulk",
    "ess_tail",
    "summarize",
    "nuts_sample",
    "BoxTransform",
    "default_box",
    "make_log_posterior",
    "uniform_box_log_prior",
    "lognormal_log_prior",
]
