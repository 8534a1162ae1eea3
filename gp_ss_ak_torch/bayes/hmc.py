"""Hamiltonian Monte Carlo + iterative NUTS over a batch of chains.

Port of gp_ss_ak_tpu/bayes/hmc.py. The JAX package writes one chain and
`jax.vmap`s it; here the chains are a leading batch axis (C, p)
throughout, with the same semantics: each chain stops its trajectory on
its own condition, a loop runs while any chain is still in it, and a
chain that has stopped is carried with its state selected away
(`torch.where`), never changed. Each leapfrog is one call of the
log-posterior on all chains, so for the GP hyperposterior one batched
K1 launch (bayes/api.py).

As in the JAX package:

- NUTS uses the ITERATIVE tree build (Phan & Pradhan's trick): a
  subtree of 2^d leapfrogs keeps a max_depth stack of checkpoint
  states; even leaves are stored at stack slot popcount(i), odd leaves
  U-turn-check against slots [popcount(i) - trailing_ones(i),
  popcount(i) - 1]. No recursion, O(depth) memory. Multinomial sampling
  inside a subtree, biased progressive sampling across subtrees.
- warmup adapts the step size by dual averaging (target accept 0.8)
  and a diagonal mass matrix from the second half of warmup.

Deliberate difference: (log p, grad log p) is carried with every
position, between leapfrog steps, across the ends of a tree and from
one transition to the next, so each leapfrog costs one evaluation of
the log posterior, not two (the JAX package re-evaluates at the start
of every leapfrog and at both ends of an HMC trajectory: 2L + 2
evaluations per HMC transition, 2n per NUTS subtree of n leaves).
An HMC transition costs L evaluations, a NUTS transition one per leaf,
and a run one more for the chains' start. For the same draws the
trajectory is the same function of z.

Deliberate difference, a repair: inside a subtree built backward in
time (negative step), the JAX package's U-turn check between a
checkpoint and the new leaf takes the pair in build order
(hmc.py:287, `_uturn(zc[j], rc[j], z, r)`), so the position difference
points against the momenta and every backward subtree of two or more
leaves reports a U-turn at its second leaf. Trees then stop at 3 or 5
leaves, the accept statistic cannot reach the 0.8 target, and dual
averaging shrinks the step size without end. The port orders each pair
in time, as the check across subtrees already does.

Randomness: a `torch.Generator` on the chains' device. It cannot give
`jax.random`'s numbers; every draw goes through a `draws` object
(`GeneratorDraws`) whose methods name the draw, so a test can replay
the JAX package's keys through a transition.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

__all__ = ["hmc_sample", "nuts_sample"]


class GeneratorDraws:
    """The random numbers of the chains from one torch.Generator: each
    call is a fresh draw for every chain. The arguments after the first
    name the draw ("accept"; "direction", depth; "leaf", depth, i) for
    replays, and are ignored here.

    Chains split over ranks (bayes/api.py, `mesh=`): every rank draws the
    whole batch's numbers and keeps its own chains' `rows`."""

    def __init__(self, generator: torch.Generator, chains: int, dim: int,
                 dtype: torch.dtype, device, rows: slice = slice(None)):
        self.generator = generator
        self.shape = (chains, dim)
        self.dtype = dtype
        self.device = device
        self.rows = rows

    def momentum(self) -> torch.Tensor:
        return torch.randn(self.shape, generator=self.generator,
                           dtype=self.dtype, device=self.device)[self.rows]

    def uniform(self, *name) -> torch.Tensor:
        return torch.rand(self.shape[:1], generator=self.generator,
                          dtype=self.dtype, device=self.device)[self.rows]


def log_post_grad_fn(log_post: Callable, counts: Optional[dict] = None):
    """lpg(z (C, p)) -> (log p (C,), grad (C, p)), detached, with a NaN
    value mapped to -inf and a NaN gradient entry to 0, per chain (a
    failed factor in one chain changes no other). Counts its calls in
    counts["evals"]."""

    def lpg(z):
        with torch.enable_grad():
            zz = z.detach().requires_grad_(True)
            v = log_post(zz)
            (g,) = torch.autograd.grad(v.sum(), zz)
        if counts is not None:
            counts["evals"] = counts.get("evals", 0) + 1
        v = v.detach()
        v = torch.where(torch.isnan(v), -torch.inf, v)
        g = torch.where(torch.isnan(g), 0.0, g)
        return v, g

    return lpg


def _leapfrog(lpg, z, r, g, eps, inv_mass):
    """One leapfrog step from (z, r) with g = grad log p(z) carried:
    one evaluation, at the new position."""
    r = r + 0.5 * eps[:, None] * g
    z = z + eps[:, None] * inv_mass * r
    lp, g = lpg(z)
    r = r + 0.5 * eps[:, None] * g
    return z, r, lp, g


def _kinetic(r, inv_mass):
    return 0.5 * torch.sum(inv_mass * r * r, dim=-1)


def _pick(cond, a, b):
    """torch.where over the chain axis, for (C,) and (C, p) tensors."""
    return torch.where(cond.view(-1, *([1] * (a.dim() - 1))), a, b)


# ---------------------------------------------------------------------------
# dual averaging (Nesterov) for step size
# ---------------------------------------------------------------------------

class _DAState(NamedTuple):
    log_eps: torch.Tensor
    log_eps_bar: torch.Tensor
    h_bar: torch.Tensor
    t: torch.Tensor


def _da_init(eps0: torch.Tensor) -> _DAState:
    return _DAState(torch.log(eps0), torch.log(eps0), torch.zeros_like(eps0),
                    torch.zeros_like(eps0))


def _da_update(s: _DAState, accept_prob, target=0.8, gamma=0.05, t0=10.0,
               kappa=0.75) -> _DAState:
    t = s.t + 1.0
    h_bar = (1.0 - 1.0 / (t + t0)) * s.h_bar + (target - accept_prob) / (
        t + t0)
    log_eps = s.log_eps_bar - torch.sqrt(t) / gamma * h_bar
    w = t ** (-kappa)
    log_eps_bar = w * log_eps + (1.0 - w) * s.log_eps_bar
    return _DAState(log_eps, log_eps_bar, h_bar, t)


# ---------------------------------------------------------------------------
# plain HMC (classic Metropolis endpoint accept)
# ---------------------------------------------------------------------------

def _hmc_transition(lpg, z, lp, g, eps, n_leapfrog: int, inv_mass, draws):
    """One HMC transition of every chain from (z, lp, g); eps (C,),
    inv_mass (C, p). Returns (z, lp, g, accept_prob, leapfrog leaves)."""
    r0 = draws.momentum() / torch.sqrt(inv_mass)
    H0 = -lp + _kinetic(r0, inv_mass)
    z1, r1, lp1, g1 = z, r0, lp, g
    for _ in range(n_leapfrog):
        z1, r1, lp1, g1 = _leapfrog(lpg, z1, r1, g1, eps, inv_mass)
    H1 = -lp1 + _kinetic(r1, inv_mass)
    dH = H0 - H1
    accept_prob = torch.clamp_max(torch.exp(torch.clamp_max(dH, 50.0)), 1.0)
    accept_prob = torch.where(torch.isnan(accept_prob), 0.0, accept_prob)
    accept = draws.uniform("accept") < accept_prob
    leaves = torch.full_like(lp, float(n_leapfrog))
    return (_pick(accept, z1, z), _pick(accept, lp1, lp),
            _pick(accept, g1, g), accept_prob, leaves)


# ---------------------------------------------------------------------------
# full-matrix mass (dense preconditioning)
# ---------------------------------------------------------------------------
#
# A diagonal mass cannot precondition a CORRELATED posterior: the
# flagship hyperposterior at large N is a tight ellipse with strong
# angle/width correlations, along whose stiff directions diagonal-mass
# HMC random-walks. With M^-1 = cov(posterior) the transformed target is
# about isotropic (Stan's dense_e). No sampler entry point uses it yet,
# as in the JAX package (gp_ss_ak_tpu/bayes/hmc.py:57-110).

def _mass_apply(Minv, r):
    """M^-1 r for r (C, p), with Minv (p, p) shared or (C, p, p)."""
    return torch.einsum("...ij,...j->...i", Minv, r)


def _leapfrog_full(lpg, z, r, g, eps, Minv):
    """One leapfrog step under a dense mass, g = grad log p(z) carried:
    one evaluation, at the new position."""
    r = r + 0.5 * eps[:, None] * g
    z = z + eps[:, None] * _mass_apply(Minv, r)
    lp, g = lpg(z)
    r = r + 0.5 * eps[:, None] * g
    return z, r, lp, g


def _kinetic_full(r, Minv):
    return 0.5 * torch.sum(r * _mass_apply(Minv, r), dim=-1)


def _hmc_transition_full(lpg, z, lp, g, eps, n_leapfrog: int, mass_chol,
                         Minv, draws):
    """One HMC transition of every chain under a dense mass matrix
    M = L L^T (`mass_chol` = L, `Minv` = M^-1, (p, p) or (C, p, p)):
    momenta r = L xi, kinetic energy r^T M^-1 r / 2, positions move along
    M^-1 r. Orientation is Stan's: M^-1 approximates the posterior
    COVARIANCE, so eps ~ O(1). (lp, g) is carried as in
    `_hmc_transition`: L evaluations. Returns (z, lp, g, accept_prob)."""
    r0 = _mass_apply(mass_chol, draws.momentum())
    H0 = -lp + _kinetic_full(r0, Minv)
    z1, r1, lp1, g1 = z, r0, lp, g
    for _ in range(n_leapfrog):
        z1, r1, lp1, g1 = _leapfrog_full(lpg, z1, r1, g1, eps, Minv)
    dH = H0 - (-lp1 + _kinetic_full(r1, Minv))
    accept_prob = torch.clamp_max(torch.exp(torch.clamp_max(dH, 50.0)), 1.0)
    accept_prob = torch.where(torch.isnan(accept_prob), 0.0, accept_prob)
    accept = draws.uniform("accept") < accept_prob
    return (_pick(accept, z1, z), _pick(accept, lp1, lp),
            _pick(accept, g1, g), accept_prob)


# ---------------------------------------------------------------------------
# iterative NUTS
# ---------------------------------------------------------------------------

class _Point(NamedTuple):
    """A position with its momentum, log density and gradient."""
    z: torch.Tensor
    r: torch.Tensor
    lp: torch.Tensor
    g: torch.Tensor


def _select(cond, a: _Point, b: _Point) -> _Point:
    return _Point(*(_pick(cond, x, y) for x, y in zip(a, b)))


class _TreeState(NamedTuple):
    prop: _Point               # current proposal (r unused)
    log_w: torch.Tensor        # subtree total log weight
    end: _Point                # forward end
    turning: torch.Tensor
    diverging: torch.Tensor
    sum_accept: torch.Tensor   # sum of min(1, exp(H0 - H)) over leaves
    n_leaves: torch.Tensor


def _popcount(x: int) -> int:
    return bin(x).count("1")


def _trailing_ones(x: int) -> int:
    # number of trailing 1-bits of x
    return _popcount(x & ~(x + 1))


def _uturn(z_a, r_a, z_b, r_b, inv_mass):
    dz = z_b - z_a
    return (torch.sum(dz * (inv_mass * r_a), dim=-1) < 0) | (
        torch.sum(dz * (inv_mass * r_b), dim=-1) < 0)


def _any(flag) -> bool:
    return bool(flag.any())


def _build_subtree(lpg, start: _Point, live, depth_max: int, depth: int,
                   eps, H0, inv_mass, draws, any_chain=_any) -> _TreeState:
    """Run up to 2^depth leapfrogs from `start` in the direction of eps
    (sign folded into eps) for the chains in `live`, with iterative
    U-turn checks via the checkpoint stack; a chain leaves when it
    turns or diverges, and the loop ends when no chain is left.
    `any_chain(flag)` says whether any chain holds a flag: with chains
    split over ranks (bayes/api.py, `mesh=`), any chain of the whole
    batch, the same answer on every rank, so each chain steps exactly as
    in the undivided batch."""
    C, dim = start.z.shape
    fwd = eps > 0
    zc = start.z.new_zeros((C, depth_max + 1, dim))   # checkpoint positions
    rc = start.z.new_zeros((C, depth_max + 1, dim))   # checkpoint momenta
    zero = torch.zeros_like(start.lp)
    no = torch.zeros_like(live)
    st = _TreeState(prop=start, log_w=torch.full_like(start.lp, -torch.inf),
                    end=start, turning=no, diverging=no, sum_accept=zero,
                    n_leaves=zero)
    cur = start
    for i in range(1 << depth):
        if i > 0 and not any_chain(live):
            break
        leaf = _Point(*_leapfrog(lpg, cur.z, cur.r, cur.g, eps, inv_mass))
        H = -leaf.lp + _kinetic(leaf.r, inv_mass)
        dH = H0 - H
        diverge = (dH < -1000.0) | torch.isnan(dH)
        log_w_leaf = torch.where(diverge, -torch.inf, dH)
        accept = torch.exp(torch.clamp_max(dH, 0.0))
        accept = torch.where(torch.isnan(accept), 0.0, accept)

        # multinomial-combine proposal
        log_w_new = torch.logaddexp(st.log_w, log_w_leaf)
        take = torch.log(draws.uniform("leaf", depth, i)) < (
            log_w_leaf - st.log_w)

        # checkpoints: even leaf -> store; odd leaf -> check ancestors
        pos = _popcount(i)
        turning = st.turning
        if i % 2 == 0:
            zc[:, pos] = _pick(live, leaf.z, zc[:, pos])
            rc[:, pos] = _pick(live, leaf.r, rc[:, pos])
        else:
            # each pair in time order: a subtree built backward has its
            # new leaf at the earlier end
            for j in range(pos - _trailing_ones(i), pos):
                zj, rj = zc[:, j], rc[:, j]
                turning = turning | _uturn(
                    _pick(fwd, zj, leaf.z), _pick(fwd, rj, leaf.r),
                    _pick(fwd, leaf.z, zj), _pick(fwd, leaf.r, rj), inv_mass)
        st = _TreeState(
            prop=_select(live & take, leaf, st.prop),
            log_w=_pick(live, log_w_new, st.log_w),
            end=_select(live, leaf, st.end),
            turning=_pick(live, turning, st.turning),
            diverging=_pick(live, st.diverging | diverge, st.diverging),
            sum_accept=st.sum_accept + torch.where(live, accept, 0.0),
            n_leaves=st.n_leaves + live.to(zero.dtype),
        )
        cur = _select(live, leaf, cur)
        live = live & ~st.turning & ~st.diverging
    return st


def _nuts_transition(lpg, z, lp, g, eps, inv_mass, draws,
                     max_depth: int = 8, any_chain=_any):
    """One NUTS transition of every chain from (z, lp, g); eps (C,),
    inv_mass (C, p). Returns (z, lp, g, accept statistic, leapfrog
    leaves). `any_chain` as in `_build_subtree`."""
    r0 = draws.momentum() / torch.sqrt(inv_mass)
    H0 = -lp + _kinetic(r0, inv_mass)
    here = _Point(z, r0, lp, g)
    prop, minus, plus = here, here, here
    log_w = torch.zeros_like(lp)
    no = torch.zeros(lp.shape, dtype=torch.bool, device=lp.device)
    turning, diverging = no, no
    sum_accept = torch.zeros_like(lp)
    n_leaves = torch.ones_like(lp)
    for depth in range(max_depth):
        active = ~turning & ~diverging
        if not any_chain(active):
            break
        go_fwd = draws.uniform("direction", depth) < 0.5
        start = _select(go_fwd, plus, minus)
        eps_signed = torch.where(go_fwd, eps, -eps)
        st = _build_subtree(lpg, start, active, max_depth, depth,
                            eps_signed, H0, inv_mass, draws, any_chain)

        # biased progressive sampling: take new subtree's proposal with
        # prob min(1, W_new / W_old)
        take = (torch.log(draws.uniform("accept", depth)) < (st.log_w - log_w)
                ) & ~st.turning & ~st.diverging
        prop = _select(active & take, st.prop, prop)
        log_w = _pick(active, torch.logaddexp(log_w, torch.where(
            st.turning | st.diverging, -torch.inf, st.log_w)), log_w)
        minus = _select(active & ~go_fwd, st.end, minus)
        plus = _select(active & go_fwd, st.end, plus)
        turning_all = _uturn(minus.z, minus.r, plus.z, plus.r, inv_mass)
        turning = _pick(active, st.turning | turning_all, turning)
        diverging = _pick(active, diverging | st.diverging, diverging)
        sum_accept = _pick(active, sum_accept + st.sum_accept, sum_accept)
        n_leaves = _pick(active, n_leaves + st.n_leaves, n_leaves)
    accept_stat = sum_accept / torch.clamp_min(n_leaves, 1.0)
    return prop.z, prop.lp, prop.g, accept_stat, n_leaves - 1.0


# ---------------------------------------------------------------------------
# the samplers: warmup (step size, then mass), then samples
# ---------------------------------------------------------------------------

def _sample(step, log_post: Callable, z0: torch.Tensor, generator,
            n_samples: int, n_warmup: int, init_step_size: float,
            stats: Optional[dict], draws=None):
    single = z0.dim() == 1
    z = z0[None] if single else z0
    C, dim = z.shape
    if draws is None:
        if generator is None:
            generator = torch.Generator(device=z.device).manual_seed(0)
        draws = GeneratorDraws(generator, C, dim, z.dtype, z.device)
    counts = {} if stats is None else stats
    counts["evals"] = 0
    lpg = log_post_grad_fn(log_post, counts)
    lp, g = lpg(z)
    inv_mass0 = torch.ones_like(z)
    da = _da_init(torch.full_like(lp, init_step_size))
    mean, m2 = torch.zeros_like(z), torch.zeros_like(z)
    count = torch.zeros_like(lp)
    leaves = []
    for _ in range(n_warmup):
        eps = torch.exp(da.log_eps)
        z, lp, g, ap, n = step(lpg, z, lp, g, eps, inv_mass0, draws)
        leaves.append(n)
        da = _da_update(da, ap)
        count1 = count + 1.0
        delta = z - mean
        mean1 = mean + delta / count1[:, None]
        m2_1 = m2 + delta * (z - mean1)
        in_2nd = da.t > (n_warmup // 2)
        mean, m2 = _pick(in_2nd, mean1, mean), _pick(in_2nd, m2_1, m2)
        count = torch.where(in_2nd, count1, count)
    var = torch.where(count[:, None] > 2,
                      m2 / torch.clamp_min(count - 1.0, 1.0)[:, None], 1.0)
    inv_mass = torch.clamp(var, 1e-4, 1e4)
    eps = torch.exp(da.log_eps_bar)
    samples, aps = [], []
    for _ in range(n_samples):
        z, lp, g, ap, n = step(lpg, z, lp, g, eps, inv_mass, draws)
        leaves.append(n)
        samples.append(z)
        aps.append(ap)
    samples = torch.stack(samples, dim=1) if samples else z.new_zeros(
        (C, 0, dim))
    aps = torch.stack(aps, dim=1) if aps else z.new_zeros((C, 0))
    counts["leaves"] = (torch.stack(leaves, dim=1) if leaves
                        else z.new_zeros((C, 0)))
    counts["step_size"], counts["inv_mass"] = eps, inv_mass
    if single:
        return samples[0], aps[0]
    return samples, aps


def hmc_sample(log_post: Callable, z0: torch.Tensor, generator=None,
               n_samples: int = 500, n_warmup: int = 300,
               init_step_size: float = 0.1, n_leapfrog: int = 16,
               stats: Optional[dict] = None, draws=None):
    """HMC chains: log_post maps z (C, p) to (C,) values; z0 is (C, p)
    (or (p,) for one chain); `generator` a torch.Generator on z0's
    device. Returns (samples (C, n_samples, p), accept_probs
    (C, n_samples)). A dict passed as `stats` receives "evals" (batched
    evaluations of log_post), "leaves" (leapfrogs per transition,
    (C, n_warmup + n_samples)), "step_size" and "inv_mass". `draws` (a
    GeneratorDraws) replaces the generator's."""

    def step(lpg, z, lp, g, eps, inv_mass, draws):
        return _hmc_transition(lpg, z, lp, g, eps, n_leapfrog, inv_mass,
                               draws)

    return _sample(step, log_post, z0, generator, n_samples, n_warmup,
                   init_step_size, stats, draws)


def nuts_sample(log_post: Callable, z0: torch.Tensor, generator=None,
                n_samples: int = 500, n_warmup: int = 300,
                init_step_size: float = 0.1, max_depth: int = 8,
                stats: Optional[dict] = None, draws=None,
                any_chain=_any):
    """NUTS chains, with the arguments and results of `hmc_sample`;
    `any_chain` as in `_build_subtree`."""

    def step(lpg, z, lp, g, eps, inv_mass, draws):
        return _nuts_transition(lpg, z, lp, g, eps, inv_mass, draws,
                                max_depth, any_chain)

    return _sample(step, log_post, z0, generator, n_samples, n_warmup,
                   init_step_size, stats, draws)
