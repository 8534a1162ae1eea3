"""Numerical-debug helpers (port of gp_ss_ak_tpu/utils/debug.py).

The analogues of the reference's debug build (-ggdb -DDBG,
make_linux:19) are NaN tracing and value checking:

- `nan_debug()`: inside the block, the first torch operation whose
  output holds a NaN raises FloatingPointError naming the operation,
  as `jax_debug_nans` does. It is a TorchDispatchMode, so it sees every
  operation that reaches a kernel, the backward's included (autograd's
  `detect_anomaly` checks only the backward). Each operation then reads
  its NaN flag on the host: for debugging, not for timing.
- `checked(fn)`: g(*args) -> (error, out); `error.throw()` raises if a
  NaN or inf appeared in the outputs (the JAX package's checkify
  wrapper, which checks inside the jitted program; eager torch has its
  outputs to look at).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


def _floats(out):
    return [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)
            and (t.is_floating_point() or t.is_complex())]


class _RaiseOnNaN(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _floats(out):
            if bool(torch.isnan(t).any()):
                raise FloatingPointError(
                    f"nan_debug: {func} produced a NaN (shape "
                    f"{tuple(t.shape)}, {t.dtype} on {t.device})")
        return out


@contextlib.contextmanager
def nan_debug(enable: bool = True):
    if not enable:
        yield
        return
    with _RaiseOnNaN():
        yield


class CheckError:
    """The error slot of `checked`: `get()` is the message or None,
    `throw()` raises FloatingPointError with it."""

    def __init__(self, message: Optional[str] = None):
        self.message = message

    def get(self) -> Optional[str]:
        return self.message

    def throw(self) -> None:
        if self.message is not None:
            raise FloatingPointError(self.message)


def checked(fn):
    """Returns g(*args) -> (error, out); error.throw() raises if any
    output holds a NaN or an inf (a host read per floating output)."""

    def g(*args, **kwargs):
        out = fn(*args, **kwargs)
        leaves = _floats(out)
        bad = [i for i, t in enumerate(leaves)
               if not bool(torch.isfinite(t).all())]
        if not bad:
            return CheckError(), out
        return CheckError(f"checked: non-finite values (NaN or inf) in "
                          f"output leaves {bad} of {len(leaves)}"), out

    return g
