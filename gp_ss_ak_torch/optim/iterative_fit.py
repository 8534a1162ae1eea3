"""The matrix-free engine's model check (port of
gp_ss_ak_tpu/optim/iterative_fit.py:43-52). The fit itself
(`make_iterative_value_and_grad`, `DENSE_MAX_N`) arrives with the
training slice."""

from __future__ import annotations

from gp_ss_ak_torch.inference.likelihoods import Gaussian
from gp_ss_ak_torch.model import GPModel
from gp_ss_ak_torch.ops.fused import _is_flagship


def supports_iterative(model: GPModel) -> bool:
    """The flagship Sum([ExpAns, Bias]) with a Gaussian likelihood and
    flat = [kernel params..., lik hypers] exactly (a model carrying mean
    hypers is refused). The JAX package also takes WarpedGaussian; the
    port does not have that likelihood yet."""
    lik = model.likelihood
    return (_is_flagship(model.kernel)
            and isinstance(lik, Gaussian)
            and model.n_params == model.kernel.n_params + lik.n_hypers)
