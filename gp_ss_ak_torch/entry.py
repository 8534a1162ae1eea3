"""Entry point: one flagship NLML + gradient evaluation, the unit of work
inside hyperparameter optimization (the torch counterpart of
`__graft_entry__.entry()` at the repository root).

    step, (flat, X, y) = entry()              # on the card
    value, grad = step(flat, X, y)

The flagship model is Sum([ExpAns, Bias]) with Gaussian noise at its
default hyperparameters; the data are N = 1024 points in [-1, 1]^3 from
numpy seed 0 with y = sin(X @ [3, 1, 2]), exactly as the JAX entry makes
them. The gradient is the dense engine's: K1 forward, the QW adjoint and
K1's closed-form backward (optim.flat_nlml_fn).
"""

from __future__ import annotations

import numpy as np
import torch

from gp_ss_ak_torch.model import default_model
from gp_ss_ak_torch.optim import flat_nlml_fn


def _flagship(n: int = 1024, d: int = 3, dtype=torch.float32,
              device="cuda"):
    rng = np.random.default_rng(0)
    X = rng.uniform(-1.0, 1.0, size=(n, d))
    y = np.sin(X @ np.array([3.0, 1.0, 2.0][:d]))
    model = default_model(input_dim=d, dtype=dtype, device=device)
    return (model, torch.as_tensor(X, dtype=dtype, device=model.pack().device),
            torch.as_tensor(y, dtype=dtype, device=model.pack().device))


def entry(dtype=torch.float32, device="cuda"):
    """(step, (flat, X, y)): step(flat, X, y) -> (value, grad), both
    tensors on `device` (the card unless the caller asks for the CPU)."""
    model, X, y = _flagship(dtype=dtype, device=device)
    f = flat_nlml_fn(model)

    def step(flat, X, y):
        flat = flat.detach().requires_grad_()
        value = f(flat, X, y)
        (grad,) = torch.autograd.grad(value, flat)
        return value.detach(), grad

    return step, (model.pack(), X, y)
