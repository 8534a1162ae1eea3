"""The example workflows of the JAX package (examples/*.py), on the port.

Each module is the counterpart of the top-level `examples/<same name>.py`,
step for step, with a `main(device="cuda", ...)` whose size arguments
default to that example's and which returns what it printed as numbers:

    python -m gp_ss_ak_torch.examples.full_workflow              # the card
    python -m gp_ss_ak_torch.examples.full_workflow --device cpu

  full_workflow         train -> model file -> serve, a NUTS
                        hyperposterior, and a distributed fit when the
                        process is one rank of several
  bayes_workflow        NUTS over the GP hypers, diagnostics, mixing
  distributed_workflow  the row-split fit and predict, against the ring
  ring_workflow         the ring's matrix-free fit and posterior mean

They run in float64 on the CPU and in float32 on the card, as the JAX
examples run in float64 on the CPU and float32 on a TPU. The mesh
examples run on a world of one (NCCL on the card, gloo on the CPU) or on
every rank of a launch (torchrun, `parallel.launch_local`); the JAX
examples' simulated 8-device CPU mesh has no counterpart but launched
ranks. Files go to a temporary directory.
"""

from __future__ import annotations

import argparse
import sys

import torch


def working_dtype(device) -> torch.dtype:
    """float32 on the card, float64 elsewhere."""
    return torch.float32 if torch.device(device).type == "cuda" \
        else torch.float64


def run(main, argv=None) -> int:
    """`python -m gp_ss_ak_torch.examples.<name> [--device DEV]`: main()
    on the card, or where --device says; exit 1 when it names a CUDA
    device that is not usable."""
    from gp_ss_ak_torch.cli import _add_device, _device

    doc = sys.modules[main.__module__].__doc__
    ap = argparse.ArgumentParser(
        description=" ".join(doc.split("\n\n")[0].split()))
    _add_device(ap)
    device = _device(ap.parse_args(argv))
    if device is None:
        return 1
    main(device=device)
    return 0
