"""Kernel registry / factory.

One table covering the reference's two string-switch factories: CLI
kernel assembly (gp_ss_ak.cpp:148-176) and model-file reading
(`ReadKerFromFile` Kernel.cpp:1281-1307), including the round-trip
quirk that White writes "White Noise" but is read back as "white".
"""

from __future__ import annotations

from typing import Dict

from gp_ss_ak_torch.kernels.anisotropic import ExpAns
from gp_ss_ak_torch.kernels.base import Kernel
from gp_ss_ak_torch.kernels.composite import Sum
from gp_ss_ak_torch.kernels.simple import Bias, White
from gp_ss_ak_torch.kernels.stationary import Exponential, RBF

_FACTORIES = {
    "rbf": RBF,
    "expans": ExpAns,
    "expan": ExpAns,  # CLI default sets KernT[0]="ExpAn" (gp_ss_ak.cpp:183)
    "exp": Exponential,
    "bias": Bias,
    "white": White,
    "white noise": White,
}


def make_kernel(name: str) -> Kernel:
    key = name.strip().lower()
    if key in _FACTORIES:
        return _FACTORIES[key]()
    raise ValueError(f"Unknown covariance function: {name!r}")


def available_kernels() -> Dict[str, type]:
    return dict(_FACTORIES)


def default_train_kernel(extra: list = None) -> Sum:
    """The CLI's default assembly: requested kernels (default ExpAns)
    plus a Bias noise component (gp_ss_ak.cpp:177-190)."""
    kerns = [make_kernel(n) for n in (extra or ["ExpAns"])]
    kerns.append(Bias())
    return Sum(kerns)
