"""Gauss-Hermite quadrature nodes/weights.

A copy of gp_ss_ak_tpu/inference/quadrature.py (numpy only). The
reference builds the Jacobi matrix with off-diagonals sqrt(k/2) and
takes eigenvalues as nodes, squared first eigenvector components as
weights (`Gauher`, GP_Utils.cpp:1082-1096). That is Golub-Welsch for
the physicists' Hermite weight e^{-x^2} with the mu0 = sqrt(pi) factor
dropped, so the weights sum to 1 and the implied mixing density has
variance 1/2 — an intentional reference-parity quirk: predictions use
z_k = mu + sigma * x_k (NOT sigma * sqrt(2) * x_k), GP_Utils.cpp:1066.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np


@lru_cache(maxsize=None)
def gauss_hermite(n: int = 20):
    """(nodes, weights) with weights summing to 1 (reference scaling)."""
    x, w = np.polynomial.hermite.hermgauss(n)
    w = w / math.sqrt(math.pi)
    return x.astype(np.float64), w.astype(np.float64)
