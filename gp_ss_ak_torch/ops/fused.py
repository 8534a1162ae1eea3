"""Differentiable fused Gram build + dispatch of the flagship model.

Forward: the fused Gram kernel K1 (ops/pairwise.py). Backward: the
closed-form cotangents of gp_ss_ak_tpu/ops/fused.py:43-58, in torch ops
(plain XLA in the JAX package, so no kernel here); the distance matrix
is rebuilt once per backward pass and autograd never runs through K1:

  A = s^2 exp(-r) + b + sn2 I,  r = ||xi - xj||
  dA/ds       -> 2 s sum(G exp(-r))
  dA/db       -> sum(G)
  dA/dsn2     -> tr(G)
  dA/dXm_i    -> 2 [ (sum_j Wsym_ij) x_i - (Wsym X)_i ],
                 W = G . s^2 exp(-r) . (-1/(2r)), zero where r = 0

Every function here also takes a batch of independent problems, the
JAX package's `jax.vmap` over ensemble members and sampler chains
written out: points (B, n, d) and hyperparameters whose leaves are (B,)
tensors (`kernel.unpack(flats.T)` of (B, p) flat vectors). The forward
is then one batched K1 launch, and the backward works per member
(W + W^T, row sums over the last axis, a batched Wsym @ Xm).

`maybe_fused_A` recognizes the CLI's flagship model (Sum([ExpAns, Bias])
+ Gaussian noise, gp_ss_ak.cpp:146-190) and builds its A = K + sn2 I
through `fused_expans_bias_A`; `fused_cross_gram` builds the serving
cross-covariance (forward only). Both return None for any other kernel,
which then takes the generic torch Gram (kernel.matrix).

Unlike the JAX package, which takes its Pallas kernel only on a TPU
above tuned sizes (fused.py:117, gaussian.py:222), the port routes the
flagship model through the wrapper at every size: the wrapper launches
the CUDA kernel for CUDA tensors and runs its plain version for CPU
tensors. The cross-Gram VJP (fused.py:64-95) serves only the JAX
package's parallel/ engines and is not ported.
"""

from __future__ import annotations

import torch
from torch.autograd.profiler import record_function

from gp_ss_ak_torch.kernels.anisotropic import ExpAns
from gp_ss_ak_torch.kernels.composite import Sum
from gp_ss_ak_torch.kernels.distance import (
    gram_sqdist,
    highest_precision,
    pad_to_3d,
    safe_sqrt,
)
from gp_ss_ak_torch.kernels.simple import Bias
from gp_ss_ak_torch.ops.pairwise import expans_bias_gram


class FusedExpansBiasA(torch.autograd.Function):
    """A = sigma^2 exp(-||xi-xj||) + bias + sn2 I over mapped points:
    K1 forward, the closed-form backward above. sigma, bias and sn2 are
    tensors (0-d, or (B,) for points (B, n, d)) or Python floats, which
    get no gradient. The backward is a profiler range,
    "FusedExpansBiasA.backward"."""

    @staticmethod
    def forward(ctx, Xm, sigma, bias, sn2):
        ctx.save_for_backward(Xm, torch.as_tensor(sigma, dtype=Xm.dtype,
                                                  device=Xm.device))
        return expans_bias_gram(Xm, sigma, bias, sn2)

    @staticmethod
    @record_function("FusedExpansBiasA.backward")
    def backward(ctx, G):
        Xm, sigma = ctx.saved_tensors
        need = ctx.needs_input_grad
        s = sigma[..., None, None]
        with highest_precision():
            r = safe_sqrt(gram_sqdist(Xm, Xm, same=True))
            W = G * torch.exp(-r)
            grad_sigma = (2.0 * sigma * torch.sum(W, dim=(-2, -1))
                          if need[1] else None)
            # inv2r = -1/(2r), 0 where r = 0 (the diagonal, coincident
            # points): no NaN or inf reaches the gradient there
            pos = r > 0
            W.mul_(s * s).mul_(torch.where(
                pos, -0.5 / torch.where(pos, r, 1.0), 0.0))
            del r, pos
            Wsym = W + W.mT
            del W
            grad_Xm = 2.0 * (torch.sum(Wsym, dim=-1, keepdim=True) * Xm
                             - Wsym @ Xm) if need[0] else None
        grad_bias = torch.sum(G, dim=(-2, -1)) if need[2] else None
        grad_sn2 = (torch.sum(torch.diagonal(G, dim1=-2, dim2=-1), dim=-1)
                    if need[3] else None)
        return grad_Xm, grad_sigma, grad_bias, grad_sn2


def fused_expans_bias_A(Xm: torch.Tensor, sigma, bias, sn2) -> torch.Tensor:
    """Differentiable A = sigma^2 exp(-||xi-xj||) + bias + sn2 I."""
    return FusedExpansBiasA.apply(Xm, sigma, bias, sn2)


def _is_flagship(kernel) -> bool:
    return (isinstance(kernel, Sum) and len(kernel.children) == 2
            and isinstance(kernel.children[0], ExpAns)
            and isinstance(kernel.children[1], Bias))


def _metric(expans: ExpAns, params, d: int, batched: bool):
    """ExpAns's metric M (d, d), or (B, d, d) for (B,) parameter leaves:
    the 3-D block per member by `torch.func.vmap`, any rock-type
    dimensions past it on the diagonal (kernels/distance.py)."""
    if not batched:
        return expans.metric(params, d)
    M3 = torch.func.vmap(lambda p: expans.metric(p, 3))(params)
    if d == 3:
        return M3
    B = M3.shape[0]
    z = M3.new_zeros((B, 3, d - 3))
    rock = params["inversewidthR"].to(M3.dtype)[:, None, None] * torch.eye(
        d - 3, dtype=M3.dtype, device=M3.device)
    return torch.cat([torch.cat([M3, z], dim=-1),
                      torch.cat([z.mT, rock], dim=-1)], dim=-2)


def mapped_points(expans: ExpAns, params, X: torch.Tensor) -> torch.Tensor:
    """Recentre X by its OWN mean + metric-map it, so Euclidean distance
    equals the reference's MahaDist (Kernel.cpp:1391-1427). X (B, n, d)
    with (B,) parameter leaves maps each member by its own mean and
    metric."""
    Xp = pad_to_3d(X)
    c = torch.mean(Xp, dim=-2, keepdim=True)
    M = _metric(expans, params, Xp.shape[-1], Xp.dim() == 3)
    return (Xp - c) @ M


def maybe_fused_A(kernel, params, sn2, X: torch.Tensor,
                  jitter: float = 0.0):
    """A = K + (sn2 + jitter) I via the fused kernel for the flagship
    model (differentiable in the hyperparameters and X), else None."""
    if not _is_flagship(kernel):
        return None
    expans_params, bias_params = params
    Xm = mapped_points(kernel.children[0], expans_params, X).contiguous()
    return fused_expans_bias_A(Xm, expans_params["Sigma"],
                               bias_params["Sigma"], sn2 + jitter)


def fused_cross_gram(kernel, params, X: torch.Tensor, Xstar: torch.Tensor):
    """Fused cross-covariance K(X, X*) for serving, else None. Both sets
    are recentred by their COMBINED mean, as kernel.matrix does
    (distance.py _recentre), not by X's own mean; for batches (B, n, d)
    and (B, m, d), each member by the combined mean of its two sets."""
    if not _is_flagship(kernel):
        return None
    expans_params, bias_params = params
    expans = kernel.children[0]
    Xp = pad_to_3d(X)
    Xsp = pad_to_3d(Xstar)
    c = (torch.sum(Xp, dim=-2, keepdim=True)
         + torch.sum(Xsp, dim=-2, keepdim=True)) / (
        Xp.shape[-2] + Xsp.shape[-2])
    M = _metric(expans, expans_params, Xp.shape[-1], Xp.dim() == 3)
    return expans_bias_gram((Xp - c) @ M, expans_params["Sigma"],
                            bias_params["Sigma"], None, Xm2=(Xsp - c) @ M)
