"""Warping functions for the warped-Gaussian likelihood.

Port of gp_ss_ak_tpu/inference/warping.py. Three families, each
parameterized by m = n_lik_hypers // 3 triplets (theta[i], theta[i+m],
theta[i+2m]) exactly as the reference (GP_Utils.cpp:434-649):

- tanh1:  g(y) = y + sum_i a_i tanh(b_i (y + c_i)),
          a_i = exp(t0_i), b_i = exp(t1_i), c_i = t2_i
          (GP_Utils.cpp:438-465)
- rbf:    g(y) = y + sum_i a_i^2 exp(-(y - c_i)^2 / s_i^2),
          a_i = exp(t0_i), s_i = exp(t1_i),
          c_i = max(max(y_train), exp(-t2_i))  — the centre is pushed
          past the training targets (GP_Utils.cpp:467-495)
- srbf:   erfc-modulated rbf with *direct* (non-exp) hypers
          (GP_Utils.cpp:497-544)

Each returns (g(y), log g'(y)), differentiable in theta and y.

`inverse` solves g(y) = z by monotone bracketing + bisection + Newton
(GP_Utils.cpp:651-763), with the correct bisection update (the
reference writes the midpoint into `ylow` on both branches,
GP_Utils.cpp:723-727). The JAX package's `lax` loops become plain loops
on tensors: each bracketing loop reads one flag back to the host per
step; the 12 bisection and 12 clipped Newton rounds are fixed.
"""

from __future__ import annotations

import math

import torch

TANH1 = "tanh1"
RBFW = "rbf"
SRBF = "srbf"
FAMILIES = (TANH1, RBFW, SRBF)


def _triplets(theta: torch.Tensor):
    m = theta.shape[0] // 3
    return theta[:m], theta[m : 2 * m], theta[2 * m : 3 * m]


def _like(v, t: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=t.dtype, device=t.device)


def warp(family: str, theta: torch.Tensor, y: torch.Tensor,
         y_train_max=None):
    """g(y), log g'(y). ``y_train_max`` feeds the rbf family's centre
    clamp (the reference uses yTarg.max() even for new data,
    GP_Utils.cpp:591)."""
    if family == TANH1:
        t0, t1, t2 = _triplets(theta)
        a = torch.exp(t0)
        b = torch.exp(t1)
        c = t2
        t = torch.tanh((y[..., None] + c) * b)            # (..., m)
        gy = y + torch.sum(a * t, dim=-1)
        gpy = 1.0 + torch.sum(a * b * (1.0 - t * t), dim=-1)
        return gy, torch.log(gpy)
    if family == RBFW:
        t0, t1, t2 = _triplets(theta)
        a = torch.exp(t0)
        s = torch.exp(t1)
        c = torch.maximum(_like(y_train_max, theta), torch.exp(-t2))
        d = y[..., None] - c
        t = (a * a) * torch.exp(-(d * d) / (s * s))
        gy = y + torch.sum(t, dim=-1)
        gpy = 1.0 + torch.sum((-2.0 / (s * s)) * d * t, dim=-1)
        return gy, torch.log(gpy)
    if family == SRBF:
        a, s, c = _triplets(theta)  # direct hypers (GP_Utils.cpp:512-514)
        d = y[..., None] - c
        d2 = d * d
        base = (a * a) * torch.exp(-d2 / (s * s))
        erfc_term = torch.special.erfc(-torch.abs(d))
        t = base * erfc_term
        gy = y + torch.sum(t, dim=-1)
        # derivative pieces per GP_Utils.cpp:522-531
        dti = torch.exp(-d2) * (-2.0 / math.sqrt(math.pi)) * base
        dti = torch.where(d > 0, -dti, dti)
        dti2 = (d * (-2.0 / (s * s))) * base * erfc_term
        gpy = 1.0 + torch.sum(dti + dti2, dim=-1)
        return gy, torch.log(gpy)
    raise ValueError(f"unknown warp family {family!r}")


def bracket(family: str, theta: torch.Tensor, z: torch.Tensor,
            y_train_max=0.0):
    """(ylow, yup, lower steps, upper steps) with g(ylow) <= z <= g(yup)
    elementwise: from y = z, step every element whose residual has the
    wrong sign by dz = max(max |z|, 1) (the reference's dz,
    GP_Utils.cpp:674-705, floored so that an all-zero z terminates)."""

    def residual(y):
        return warp(family, theta, y, y_train_max)[0] - z

    dz = torch.clamp_min(torch.max(torch.abs(z)), 1.0)
    r0 = residual(z)
    ylow, r, n_low = z, r0, 0
    while bool(torch.any(r > 0)):
        ylow = torch.where(r > 0, ylow - dz, ylow)
        r = residual(ylow)
        n_low += 1
    yup, r, n_up = z, r0, 0
    while bool(torch.any(r < 0)):
        yup = torch.where(r < 0, yup + dz, yup)
        r = residual(yup)
        n_up += 1
    return ylow, yup, n_low, n_up


def inverse(family: str, theta: torch.Tensor, z: torch.Tensor,
            y_train_max=0.0, max_expand: int = 64):
    """Solve g(y) = z elementwise.

    tanh1/rbf: `bracket`, 12 bisection rounds, then 12 clipped Newton
    rounds (GP_Utils.cpp:706-759). srbf: the reference's closed-form
    chain (GP_Utils.cpp:765-791). `max_expand` is kept from the JAX
    signature, which does not use it either: the bracket has no cap.
    """
    if family == SRBF:
        # replicate the reference's sequential transform; only the last
        # triplet effectively survives, as in the C++ loop.
        m = theta.shape[0] // 3
        ymax = _like(y_train_max, theta)
        g = z
        for i in range(m):
            a = torch.exp(theta[i])
            s = torch.exp(theta[i + m])
            c = torch.maximum(ymax, torch.exp(-theta[i + 2 * m]))
            lny = torch.log(z / (a * a))
            g = torch.sqrt(-(s * s) * lny) + c
        return g

    ylow, yup, _, _ = bracket(family, theta, z, y_train_max)
    for _ in range(12):
        mid = 0.5 * (ylow + yup)
        r = warp(family, theta, mid, y_train_max)[0] - z
        ylow = torch.where(r < 0, mid, ylow)
        yup = torch.where(r > 0, mid, yup)
    y = 0.5 * (ylow + yup)
    for _ in range(12):
        gy, lgpy = warp(family, theta, y, y_train_max)
        y = torch.clamp(y - (gy - z) / torch.exp(lgpy), ylow, yup)
    return y
