"""Additive composite kernel ("Hyb" in the reference).

`HybKerns` sums children's covariance and concatenates their flat
parameters (Kernel.cpp:82-169, Kernel.h:158-253). The composite holds a
tuple of child descriptors; its params are a tuple of child param
dicts, and flat packing follows child order so packed vectors match
reference model files.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from gp_ss_ak_torch.kernels.base import Kernel


class Sum(Kernel):
    name = "Hyb"

    def __init__(self, children: Sequence[Kernel]):
        self.children: Tuple[Kernel, ...] = tuple(children)
        if not self.children:
            raise ValueError("Sum kernel needs at least one child")

    @property
    def n_params(self) -> int:
        return sum(c.n_params for c in self.children)

    @property
    def param_names(self):  # type: ignore[override]
        return tuple(
            f"{i}:{n}" for i, c in enumerate(self.children) for n in c.param_names
        )

    def init_params(self, dtype: torch.dtype, device: torch.device):
        return tuple(c.init_params(dtype, device) for c in self.children)

    def file_param_names(self):
        return tuple(n for c in self.children for n in c.file_param_names())

    def matrix(self, params, X1, X2, same: bool = False):
        K = self.children[0].matrix(params[0], X1, X2, same)
        for c, p in zip(self.children[1:], params[1:]):
            K = K + c.matrix(p, X1, X2, same)
        return K

    def diag(self, params, X):
        d = self.children[0].diag(params[0], X)
        for c, p in zip(self.children[1:], params[1:]):
            d = d + c.diag(p, X)
        return d

    def pack(self, params) -> torch.Tensor:
        return torch.cat([c.pack(p) for c, p in zip(self.children, params)])

    def unpack(self, flat: torch.Tensor):
        out = []
        i = 0
        for c in self.children:
            out.append(c.unpack(flat[i : i + c.n_params]))
            i += c.n_params
        return tuple(out)

    def __repr__(self):
        inner = ", ".join(repr(c) for c in self.children)
        return f"Sum([{inner}])"
