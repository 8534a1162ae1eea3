"""Kernel interface: stateless descriptors + parameter dicts.

As in gp_ss_ak_tpu/kernels/base.py, a kernel is a *stateless
descriptor*: static metadata (name, ordered parameter names, init
values matching Kernel.cpp's `setInitPars`) plus functions of
``(params, X...)``. Parameters live in plain dicts of 0-d tensors, so
one descriptor serves any dtype and device.

Parameter ordering follows the reference's flat indexing exactly
(Kernel.cpp setParam/getParam switches) so packed vectors and model
files round-trip against reference-format files.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

Params = Dict[str, torch.Tensor]


class Kernel:
    """Base descriptor. Subclasses define metadata + matrix()/diag()."""

    #: kernel name as written to model files (Kernel.cpp KernelName=)
    name: str = "base"
    #: ordered (index -> short param name); file names get f"_{suffix}"
    param_names: Tuple[str, ...] = ()
    #: default initial values, same order (Kernel.cpp setInitPars)
    init_values: Tuple[float, ...] = ()
    #: suffix appended to param names in files ("" = use name as is)
    param_suffix: str = ""

    @property
    def n_params(self) -> int:
        return len(self.param_names)

    def init_params(self, dtype: torch.dtype,
                    device: torch.device) -> Params:
        return {
            n: torch.tensor(v, dtype=dtype, device=device)
            for n, v in zip(self.param_names, self.init_values)
        }

    def file_param_names(self) -> Tuple[str, ...]:
        sfx = self.param_suffix
        return tuple(f"{n}_{sfx}" if sfx else n for n in self.param_names)

    def matrix(self, params: Params, X1: torch.Tensor, X2: torch.Tensor,
               same: bool = False) -> torch.Tensor:
        """Cross-covariance K(X1, X2). ``same=True`` marks X1 is X2
        (the reference's identity check, Kernel.cpp:261)."""
        raise NotImplementedError

    def diag(self, params: Params, X: torch.Tensor) -> torch.Tensor:
        """diag K(X, X) as a (n,) vector (Kernel.h diag_Compute)."""
        raise NotImplementedError

    # -- flat packing (reference order) ---------------------------------
    def pack(self, params: Params) -> torch.Tensor:
        return torch.stack([params[n] for n in self.param_names])

    def unpack(self, flat: torch.Tensor) -> Params:
        return {n: flat[i] for i, n in enumerate(self.param_names)}

    def __repr__(self):
        return f"{type(self).__name__}()"


def check_params(kernel: Kernel, params: Params) -> None:
    """Raise ValueError naming the parameters of `kernel` that `params`
    lacks (gp_ss_ak_tpu/kernels/base.py:73-76)."""
    missing = set(kernel.param_names) - set(params)
    if missing:
        raise ValueError(f"{kernel.name}: missing params {sorted(missing)}")
