"""Checkpoint / resume: a numpy copy of gp_ss_ak_tpu/utils/checkpoint.py.

Reference philosophy, kept: a checkpoint is HYPERPARAMETERS plus small
driver state; posterior matrices are always re-derived
(gp_ss_ak.cpp:382-395). Adds what the reference lacks: mid-run
optimizer checkpoints (periodic, via the fit callback) and HMC chain
state, as .npz + JSON sidecars. The files are the JAX package's, key for
key, so a fit checkpointed by one package resumes in the other.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np


def save_fit_checkpoint(path: str, x: np.ndarray, fun: float,
                        iteration: int) -> None:
    np.savez(path + ".npz", x=np.asarray(x, np.float64),
             fun=np.float64(fun), iteration=np.int64(iteration))
    with open(path + ".json", "w") as f:
        json.dump({"iteration": int(iteration), "nlml": float(fun)}, f)


def load_fit_checkpoint(path: str) -> Optional[dict]:
    if not os.path.exists(path + ".npz"):
        return None
    z = np.load(path + ".npz")
    return {"x": z["x"], "fun": float(z["fun"]),
            "iteration": int(z["iteration"])}


class CheckpointCallback:
    """Wraps any fit callback; saves every `every` iterations."""

    def __init__(self, path: str, every: int = 10, inner=None):
        self.path = path
        self.every = max(1, every)
        self.inner = inner

    def __call__(self, iteration, x, fun):
        if iteration % self.every == 0:
            save_fit_checkpoint(self.path, x, fun, iteration)
        if self.inner is not None:
            self.inner(iteration, x, fun)


def save_chains(path: str, theta: np.ndarray,
                accept_stats: np.ndarray = None) -> None:
    np.savez(path, theta=np.asarray(theta),
             accept=np.asarray(accept_stats)
             if accept_stats is not None else np.zeros(0))


def load_chains(path: str):
    z = np.load(path if path.endswith(".npz") else path + ".npz")
    return z["theta"], z["accept"]
