"""High-level Bayesian interface: sample GP hyperposteriors and mix
predictions over the samples (BASELINE.json config 4).

Port of gp_ss_ak_tpu/bayes/api.py. The chains are one batch: each
leapfrog evaluates the NLML and its gradient for every chain at once
(optim.api.batched_nlml_fn: for the flagship model one batched K1
launch, one batched potrf and one batched QW adjoint over the chains).
The JAX package's hooks for its mesh engines, `mesh=` (chains sharded
over devices) and `nlml_value_and_grad=` (the distributed NLML inside
every leapfrog), wait for the port of parallel/ and raise.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from gp_ss_ak_torch.bayes import hmc as _hmc
from gp_ss_ak_torch.bayes.priors import (
    BoxTransform,
    default_box,
    make_log_posterior,
)
from gp_ss_ak_torch.ensemble.batched import (
    PARALLEL_NOT_PORTED,
    _as,
    predict_batched,
)
from gp_ss_ak_torch.model import GPModel
from gp_ss_ak_torch.optim.api import batched_nlml_fn

#: hyper samples predicted at once by `predictive_mixture`, as one batch
MIXTURE_CHUNK = 16


def sample_hyperposterior(
    model: GPModel,
    X,
    y,
    seed: Union[int, torch.Generator] = 0,
    n_samples: int = 300,
    n_warmup: int = 300,
    n_chains: int = 4,
    sampler: str = "nuts",
    init_jitter: float = 0.5,
    box: Optional[BoxTransform] = None,
    log_prior=None,
    mesh=None,
    nlml_fn=None,
    nlml_value_and_grad=None,
    stats: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (samples, accept_stats): samples has shape
    (n_chains, n_samples, n_params) in CONSTRAINED theta space, on the
    model's device and dtype.

    `seed` is an int or a torch.Generator on the model's device.
    `nlml_fn` (flat thetas (C, p) -> (C,) NLML, differentiable)
    overrides the dense objective. `stats` receives the sampler's
    counts (bayes/hmc.py: "evals", "leaves", ...)."""
    if mesh is not None or nlml_value_and_grad is not None:
        raise NotImplementedError(
            "sample_hyperposterior(mesh=..., nlml_value_and_grad=...) "
            + PARALLEL_NOT_PORTED)
    flat0 = model.pack().detach()
    dtype, device = flat0.dtype, flat0.device
    p = flat0.shape[0]
    box = box or default_box(p, dtype, device)
    if nlml_fn is None:
        f = batched_nlml_fn(model)
        Xc = _as(model, X).expand(n_chains, *X.shape)
        yc = _as(model, y).expand(n_chains, *y.shape)

        def nlml_fn(t):
            return f(t, Xc, yc)
    log_post = make_log_posterior(nlml_fn, box, log_prior)

    if isinstance(seed, torch.Generator):
        gen = seed
    else:
        gen = torch.Generator(device=device).manual_seed(int(seed))
    z_map = box.inverse(flat0)
    z0 = z_map[None, :] + init_jitter * torch.randn(
        (n_chains, p), generator=gen, dtype=dtype, device=device)
    if sampler == "nuts":
        z_samps, aps = _hmc.nuts_sample(
            log_post, z0, gen, n_samples=n_samples, n_warmup=n_warmup,
            stats=stats)
    elif sampler == "hmc":
        z_samps, aps = _hmc.hmc_sample(
            log_post, z0, gen, n_samples=n_samples, n_warmup=n_warmup,
            stats=stats)
    else:
        raise ValueError(f"sampler must be 'nuts' or 'hmc', got {sampler!r}")
    return box.forward(z_samps), aps


def predictive_mixture(model: GPModel, X, y, Xstar, theta_samples,
                       thin: int = 1):
    """Posterior-predictive mean/variance mixed over hyper samples:
    mu = E_s[mu_s], var = E_s[var_s + mu_s^2] - mu^2 (law of total
    variance). theta_samples: (chains, samples, p) or (samples, p). The
    samples are predicted MIXTURE_CHUNK at a time, each chunk a batch
    (ensemble.batched.predict_batched)."""
    Xd, yd, Xs = _as(model, X), _as(model, y), _as(model, Xstar)
    th = _as(model, theta_samples)
    if th.dim() == 3:
        th = th.reshape(-1, th.shape[-1])
    th = th[::thin]
    mus, vars_ = [], []
    with torch.no_grad():
        for s in range(0, th.shape[0], MIXTURE_CHUNK):
            part = th[s:s + MIXTURE_CHUNK]
            b = part.shape[0]
            mu, var = predict_batched(model, part, Xd.expand(b, *Xd.shape),
                                      yd.expand(b, *yd.shape),
                                      Xs.expand(b, *Xs.shape))
            mus.append(mu)
            vars_.append(var)
    mus, vars_ = torch.cat(mus), torch.cat(vars_)
    mu_bar = torch.mean(mus, dim=0)
    var_bar = torch.mean(vars_ + mus ** 2, dim=0) - mu_bar ** 2
    return mu_bar, torch.clamp_min(var_bar, 0.0)
