"""What every closed loop shares. A traffic file names its loop, a module
loops/<loop>.py whose `LOOP` is a subclass of `Loop`; the harness finds
it by that name (manifest.loop).

A loop makes the cell's data from the seed and the program's objects
(`setup`), warms every shape the window uses (`warm`), measures first
predictions where it has them (`first_predict`), runs the window
(`window`, one client), hands the answers to compare to `answers`, and
frees the program's state (`release`). After that it judges them:
`numbers` recomputes them with the plain reference that the
configuration names (reference/<module>.py) in float64 and returns every
compared number, and `produce` puts the reference in the control's
precision in the program's place. The program's entry points are the
only part of it a loop calls.
"""

from __future__ import annotations

import math

import numpy as np

from port_bench import data, manifest


def worst(values) -> float:
    """The largest value; NaN if any is NaN (a NaN never passes)."""
    vals = [float(v) for v in values]
    return math.nan if any(v != v for v in vals) else max(vals)


class Loop:
    def __init__(self, traffic, config, seed, device):
        import torch

        from gp_ss_ak_torch.data import MODE_SYMMETRIC, prepare

        self.traffic, self.config, self.seed = traffic, config, seed
        self.device = device
        self.X_raw, self.y_raw = data.ore_body(seed, config["n"])
        if self.X_raw.shape[1] != config["d"]:
            raise ValueError(f"the data has {self.X_raw.shape[1]} "
                             f"coordinates, the configuration {config['d']}")
        # the port's own standardization, as the CLI's train applies it
        self.Xs, self.ys, self.stats = prepare(self.X_raw, self.y_raw,
                                               MODE_SYMMETRIC)
        self.dtype = getattr(torch, config["dtype"])
        self.theta0 = np.asarray(config["hyper"], np.float64)
        self.ref = manifest.reference(config["reference"]["module"])

    def model(self):
        """The program's model, Sum(config's kernels) with a Gaussian
        likelihood, at the configuration's flat hyperparameters (the
        kernels' first, the likelihood's after them)."""
        from gp_ss_ak_torch.kernels import Sum, make_kernel
        from gp_ss_ak_torch.model import from_flat

        names = self.config["kernels"]
        k = Sum([make_kernel(n) for n in names]).n_params
        return from_flat(names, self.theta0, self.theta0[k:],
                         self.config["d"], self.dtype, self.device)

    def sync(self):
        import torch

        if self.device != "cpu":
            torch.cuda.synchronize()

    def first_predict(self):
        return []

    def summary(self, record) -> str:
        """A line on standard error about the window, or ""."""
        return ""

    def release(self):
        pass

    # -- the comparison ---------------------------------------------------

    def std_abs(self) -> float:
        """The largest gap between the port's standardized inputs and
        targets and the reference's, from the same raw data."""
        Xs, ys, _, _ = self.ref.standardize(self.X_raw, self.y_raw)
        return max(float(np.max(np.abs(self.Xs - Xs))),
                   float(np.max(np.abs(self.ys - ys))))

    def reference_inputs(self, prec):
        """The reference's own standardized data on the device, in
        `prec`'s dtype: (Xs, ys, x_offset, x_scale)."""
        import torch

        self.ref.no_tf32()
        Xs, ys, x_off, x_scale = self.ref.standardize(self.X_raw,
                                                      self.y_raw)

        def put(a):
            return torch.as_tensor(a, dtype=prec.dtype, device=self.device)
        return put(Xs), put(ys), x_off, x_scale

    def factor(self, Xs, theta, prec):
        import torch

        th = torch.as_tensor(theta, dtype=prec.dtype, device=self.device)
        return self.ref.factor(Xs, th, prec,
                               self.config["reference"]["tile"])
