"""Standardization ("SS" = symmetric standardization) + statistics.

Reference behavior (Control.cpp:142-324):

Per-column statistics over [y, X_0, ..., X_{d-1}] (row 0 is the
target): min / max / mean / std (ddof=1), plus the *global* min/max
over all input columns (MaxTotalin/MinTotalin) and over the target
(Control.h:46-73).

Three schemes produce (offset, scale) pairs and transform
x' = (x - offset) / scale:

- mode 0 "MeanStd":   offset = mean, scale = std  (Control.cpp:257-276)
- mode 1 "symmetric": offset = (max+min)/2, scale = (max-min)/2, with
  the first three input columns sharing the GLOBAL input min/max —
  preserving the 3-D spatial aspect ratio of drill-hole coordinates —
  and columns >= 4 per-column (Control.cpp:299-324). This is the CLI
  default (-pm 1).
- mode 2 "zeroandone": offset = 0.5*min, scale = 0.5*(max-min)
  (Control.cpp:278-296).

The statistics file `<model>_Statistics.txt` is CSV with 6 columns
(offset, scale, min, max, mean, std) and 1+d rows (y first), written on
train and reloaded on test (Control.cpp:151-163, 187-194).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

MODE_MEANSTD = 0
MODE_SYMMETRIC = 1
MODE_ZERO_ONE = 2


@dataclass
class Statistics:
    """Columns of `<model>_Statistics.txt` (row 0 = target y)."""

    offset: np.ndarray  # (1+d,)
    scale: np.ndarray   # (1+d,)
    min: np.ndarray
    max: np.ndarray
    mean: np.ndarray
    std: np.ndarray

    @property
    def input_dim(self) -> int:
        return self.offset.shape[0] - 1

    def as_matrix(self) -> np.ndarray:
        return np.stack(
            [self.offset, self.scale, self.min, self.max, self.mean, self.std],
            axis=1,
        )

    @classmethod
    def from_matrix(cls, M: np.ndarray) -> "Statistics":
        return cls(*(np.asarray(M[:, j], dtype=np.float64) for j in range(6)))

    def save(self, path: str) -> None:
        np.savetxt(path, self.as_matrix(), delimiter=",", fmt="%.16e")

    @classmethod
    def load(cls, path: str) -> "Statistics":
        return cls.from_matrix(np.loadtxt(path, delimiter=","))


def compute_statistics(X: np.ndarray, y: np.ndarray, mode: int) -> Statistics:
    """Column stats + scheme-specific (offset, scale)."""
    X = np.asarray(X, np.float64)
    y = np.asarray(y, np.float64).reshape(-1)
    cols = [y] + [X[:, j] for j in range(X.shape[1])]
    mins = np.array([c.min() for c in cols])
    maxs = np.array([c.max() for c in cols])
    means = np.array([c.mean() for c in cols])
    stds = np.array([c.std(ddof=1) for c in cols])

    d = X.shape[1]
    offset = np.zeros(1 + d)
    scale = np.ones(1 + d)
    if mode == MODE_MEANSTD:
        offset, scale = means.copy(), stds.copy()
    elif mode == MODE_SYMMETRIC:
        gmin_in, gmax_in = X.min(), X.max()
        offset[0] = 0.5 * (maxs[0] + mins[0])
        scale[0] = 0.5 * (maxs[0] - mins[0])
        shared = min(3, d)  # reference hard-codes 3 (Control.cpp:306-310)
        for j in range(shared):
            offset[1 + j] = 0.5 * (gmax_in + gmin_in)
            scale[1 + j] = 0.5 * (gmax_in - gmin_in)
        for j in range(shared, d):
            offset[1 + j] = 0.5 * (maxs[1 + j] + mins[1 + j])
            scale[1 + j] = 0.5 * (maxs[1 + j] - mins[1 + j])
    elif mode == MODE_ZERO_ONE:
        offset = 0.5 * mins
        scale = 0.5 * (maxs - mins)
    else:
        raise ValueError(f"Unrecognised preparation method {mode}")
    return Statistics(offset, scale, mins, maxs, means, stds)


def apply(stats: Statistics, X: np.ndarray, y: np.ndarray = None,
          yscale: bool = True):
    """Forward transform with saved (offset, scale)."""
    Xs = (np.asarray(X, np.float64) - stats.offset[1:]) / stats.scale[1:]
    if y is None:
        return Xs
    ys = np.asarray(y, np.float64)
    if yscale:
        ys = (ys - stats.offset[0]) / stats.scale[0]
    return Xs, ys


def unapply_x(stats: Statistics, X: np.ndarray) -> np.ndarray:
    return np.asarray(X, np.float64) * stats.scale[1:] + stats.offset[1:]


def unapply_y(stats: Statistics, y: np.ndarray) -> np.ndarray:
    """Inverse for targets/predicted means (Control.cpp:221-237)."""
    return np.asarray(y, np.float64) * stats.scale[0] + stats.offset[0]


def unapply_var(stats: Statistics, var: np.ndarray) -> np.ndarray:
    """Predictive-variance inverse: std' = sqrt(var * scale^2)
    (postData_var, Control.cpp:238-255 — note it returns a STD)."""
    return np.sqrt(np.asarray(var, np.float64) * stats.scale[0] ** 2)


def prepare(X: np.ndarray, y: np.ndarray, mode: int = MODE_SYMMETRIC,
            yscale: bool = True) -> Tuple[np.ndarray, np.ndarray, Statistics]:
    """Train-time: compute stats and transform (prepareData,
    Control.cpp:142-195)."""
    stats = compute_statistics(X, y, mode)
    Xs, ys = apply(stats, X, y, yscale)
    return Xs, ys, stats
