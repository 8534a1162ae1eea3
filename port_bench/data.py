"""Inputs made from `--seed`: drill-hole composites, block centres and
probe vectors. The program receives these arrays and nothing else.

`ore_body` is a frozen copy of chip_smoke.py's `ore_body` (at the
commit that added this benchmark), so that the data cannot move with
the program's smoke run.
"""

from __future__ import annotations

import numpy as np

#: the side of the synthetic deposit, metres
CUBE_M = 300.0


def ore_body(seed: int, n: int):
    """A smooth synthetic 3-D ore body in drill-hole coordinates
    (metres in a 300 m cube) with 0.05 measurement noise."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(0.0, 300.0, size=(n, 3))
    u = X / 150.0 - 1.0
    y = (1.2 + 0.6 * np.sin(1.7 * u[:, 0] + 0.4) * np.cos(1.3 * u[:, 1])
         + 0.4 * u[:, 2] + 0.25 * np.sin(2.1 * u[:, 0] * u[:, 2])
         + 0.05 * rng.normal(size=n))
    return X, y


def block_grid(seed: int, spacing_m: float) -> np.ndarray:
    """The centres of a regular block model over the cube, in raster
    order (x fastest): spacing_m apart along each axis, offset from the
    cube's corner by a fraction of a block drawn from the seed, so every
    seed has the same number of blocks."""
    per_axis = int(round(CUBE_M / spacing_m))
    offset = np.random.default_rng([seed, 1]).uniform(0.0, spacing_m, 3)
    axis = np.arange(per_axis) * spacing_m
    gz, gy, gx = np.meshgrid(axis, axis, axis, indexing="ij")
    return np.stack([gx.ravel(), gy.ravel(), gz.ravel()], 1) + offset


def rademacher(seed: int, shape, stream: int, device):
    """A float32 matrix of +-1 drawn on `device` by a torch.Generator
    seeded from (seed, stream)."""
    import torch

    key = int(np.random.default_rng([seed, stream]).integers(2 ** 62))
    g = torch.Generator(device=device).manual_seed(key)
    bits = torch.randint(0, 2, shape, generator=g, device=device)
    return (2 * bits - 1).to(torch.float32)


def draw(seed: int, k: int, n: int, stream: int) -> np.ndarray:
    """k indices out of n, without replacement, from (seed, stream)."""
    rng = np.random.default_rng([seed, stream])
    return np.sort(rng.choice(n, size=min(k, n), replace=False))
