"""High-level Bayesian interface: sample GP hyperposteriors and mix
predictions over the samples (BASELINE.json config 4).

Port of gp_ss_ak_tpu/bayes/api.py. The chains are one batch: each
leapfrog evaluates the NLML and its gradient for every chain at once
(optim.api.batched_nlml_fn: for the flagship model one batched K1
launch, one batched potrf and one batched QW adjoint over the chains).

The hooks for the mesh engines (parallel/):
  * `mesh=` splits the chains over the ranks of a parallel.Mesh. Every
    rank draws the whole batch's random numbers and keeps its chains',
    and the tree loops end when no chain on any rank is left in them, so
    each chain samples exactly what it samples in the undivided batch;
    the samples are gathered onto every rank.
  * `nlml_value_and_grad=` (flat (p,) -> (NLML, gradient), e.g. a
    parallel.make_dist_nlml_and_grad function closed over the rank's
    rows) puts an objective with an explicit gradient inside every
    leapfrog; the chains then run one after another, since each
    evaluation already spans the mesh. The two exclude each other, as in
    the JAX package.
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
from gp_ss_ak_torch.ensemble.batched import _as, predict_batched
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
    overrides the dense objective. `mesh` and `nlml_value_and_grad` are
    the hooks of the module docstring; with `mesh`, n_chains >=
    mesh.size and the result is the same on every rank. `stats`
    receives the sampler's counts (bayes/hmc.py: "evals", "leaves",
    ...): with `mesh`, this rank's chains'; run one after another, the
    evaluations summed and the rest joined over the chains."""
    if nlml_value_and_grad is not None:
        if nlml_fn is not None:
            raise ValueError("pass nlml_fn or nlml_value_and_grad, not "
                             "both")
        if mesh is not None:
            raise ValueError("nlml_value_and_grad occupies the mesh with "
                             "the data axis; chain sharding (mesh=) "
                             "cannot be combined with it")
    if sampler not in ("nuts", "hmc"):
        raise ValueError(f"sampler must be 'nuts' or 'hmc', got {sampler!r}")
    run = _hmc.nuts_sample if sampler == "nuts" else _hmc.hmc_sample
    flat0 = model.pack().detach()
    dtype, device = flat0.dtype, flat0.device
    p = flat0.shape[0]
    box = box or default_box(p, dtype, device)
    lo, hi = 0, n_chains
    if mesh is not None:
        from gp_ss_ak_torch.parallel import comm

        if n_chains < mesh.size:
            raise ValueError(f"sample_hyperposterior: {n_chains} chains over "
                             f"{mesh.size} ranks; give every rank one")
        lo, hi = comm.block_bounds(mesh, n_chains)
    if nlml_value_and_grad is not None:
        nlml_fn = _explicit_gradient(nlml_value_and_grad)
    elif nlml_fn is None:
        f = batched_nlml_fn(model)
        Xc = _as(model, X).expand(hi - lo, *X.shape)
        yc = _as(model, y).expand(hi - lo, *y.shape)

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
    kw = dict(n_samples=n_samples, n_warmup=n_warmup)
    if nlml_value_and_grad is not None:
        # one chain at a time: each leapfrog already spans the mesh
        parts = []
        for c in range(n_chains):
            st = {}
            parts.append(run(log_post, z0[c:c + 1], gen, stats=st, **kw)
                         + (st,))
        z_samps = torch.cat([q[0] for q in parts])
        aps = torch.cat([q[1] for q in parts])
        if stats is not None:
            stats["evals"] = sum(q[2]["evals"] for q in parts)
            for k in ("leaves", "step_size", "inv_mass"):
                stats[k] = torch.cat([q[2][k] for q in parts])
    elif mesh is not None:
        draws = _hmc.GeneratorDraws(gen, n_chains, p, dtype, device,
                                    rows=slice(lo, hi))
        if sampler == "nuts":
            kw["any_chain"] = lambda flag: comm.any_rank(mesh, flag.any())
        z_s, ap = run(log_post, z0[lo:hi], None, stats=stats, draws=draws,
                      **kw)
        S = z_s.shape[1]
        out = comm.all_gather_blocks(mesh, torch.cat(
            [z_s.reshape(hi - lo, -1), ap], dim=1), n_chains)
        z_samps, aps = out[:, :S * p].reshape(n_chains, S, p), out[:, S * p:]
    else:
        z_samps, aps = run(log_post, z0, gen, stats=stats, **kw)
    return box.forward(z_samps), aps


class _ExplicitGradient(torch.autograd.Function):
    """NLML of one flat theta from a value-and-gradient function: the
    forward calls it, the backward hands back its gradient, so autograd
    never runs through the objective (the JAX package's custom VJP)."""

    @staticmethod
    def forward(ctx, theta, value_and_grad):
        with torch.enable_grad():     # a forward runs without autograd
            v, g = value_and_grad(theta.detach())
        ctx.save_for_backward(torch.as_tensor(g, dtype=theta.dtype,
                                              device=theta.device))
        return torch.as_tensor(v, dtype=theta.dtype, device=theta.device)

    @staticmethod
    def backward(ctx, ct):
        (g,) = ctx.saved_tensors
        return ct * g, None


def _explicit_gradient(value_and_grad):
    """The (C, p) -> (C,) objective of `value_and_grad` (flat (p,) ->
    (NLML, gradient)), one call per chain."""

    def nlml_fn(t):
        return torch.stack([_ExplicitGradient.apply(row, value_and_grad)
                            for row in t])

    return nlml_fn


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
