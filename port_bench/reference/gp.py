"""Plain reference of the benchmark's GP: Sum([ExpAns, Bias]) with
Gaussian noise, written from the model's equations in plain PyTorch.

    hyperparameters (flat, the model file's order):
      [AngleX, iwx, AngleY, iwy, AngleZ, iwz, Sigma, iwR, bias, sn2]
    M   = R diag(iwx, iwy, iwz) R^T, R the rotation of the three angles
    A_ij = Sigma^2 exp(-||M (x_i - x_j)||) + bias + sn2 [i == j]
    NLML = 1/2 y' A^-1 y + 1/2 log det A + n/2 log 2 pi

It redoes the symmetric standardization from the raw data and factors A
by a tiled right-looking Cholesky that holds only the lower tiles, so
N = 100000 fits on one card in float64 (40 GB). It imports nothing of
the program, of the JAX package or of JAX, and takes nothing the
program made.

`Prec` sets the arithmetic: "f64" for the reference, "tf32" for the
control, which computes the same in float32 with the operands of every
matrix product rounded to TF32's 10 mantissa bits (float32 sums), as a
TF32 tensor-core product takes them, except inside the factorization:
a Cholesky on the card (cuSOLVER's potrf) has no TF32 path, so the
control factors in full float32, as the program does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

N_HYPER = 10


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to nearest with TF32's 10 mantissa bits."""
    bits = t.float().contiguous().view(torch.int32)
    return torch.bitwise_and(bits + 0x1000, -0x2000).view(torch.float32)


@dataclass(frozen=True)
class Prec:
    name: str = "f64"

    @property
    def dtype(self):
        return torch.float64 if self.name == "f64" else torch.float32

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "tf32":
            # the rounded values, with the gradient of the unrounded ones
            a = a + (round_tf32(a) - a).detach()
            b = b + (round_tf32(b) - b).detach()
        return a @ b


F64 = Prec("f64")
TF32 = Prec("tf32")
#: the control: the nearest precision below the configurations' float32
CONTROL = TF32


def no_tf32():
    """Keep torch's own float32 products in full float32: the control's
    TF32 rounding is explicit (`Prec.mm`), and nothing else may add
    any."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def standardize(X: np.ndarray, y: np.ndarray):
    """Symmetric standardization: y by the midpoint and half-range of its
    values; the three coordinates share the midpoint and half-range of
    all coordinates together, so the deposit keeps its aspect ratio.
    Returns (Xs, ys, x_offset, x_scale)."""
    X = np.asarray(X, np.float64)
    y = np.asarray(y, np.float64)
    lo, hi = X.min(), X.max()
    x_off, x_scale = 0.5 * (hi + lo), 0.5 * (hi - lo)
    y_off, y_scale = 0.5 * (y.max() + y.min()), 0.5 * (y.max() - y.min())
    return (X - x_off) / x_scale, (y - y_off) / y_scale, x_off, x_scale


def metric(theta: torch.Tensor) -> torch.Tensor:
    """M = R diag(iwx, iwy, iwz) R^T of the flat hyperparameters."""
    a, b, t = theta[0], theta[2], theta[4]
    ca, sa, cb, sb = torch.cos(a), torch.sin(a), torch.cos(b), torch.sin(b)
    ct, st = torch.cos(t), torch.sin(t)
    R = torch.stack([
        torch.stack([ca * ct + sa * sb * st, -sa * ct + ca * sb * st,
                     -cb * st]),
        torch.stack([sa * cb, ca * cb, sb]),
        torch.stack([ca * st - sa * sb * ct, -sa * st - ca * sb * ct,
                     cb * ct])])
    lam = torch.stack([theta[1], theta[3], theta[5]])
    return (R * lam[None, :]) @ R.T


def gram(Xm_rows: torch.Tensor, Xm: torch.Tensor, theta: torch.Tensor,
         row0: Optional[int]) -> torch.Tensor:
    """Rows of A (or of K + bias when row0 is None: a cross block with
    no diagonal) over metric-mapped points, by direct differences. With
    row0, row i of the block is point row0 + i, and its diagonal entry
    is Sigma^2 + bias + sn2 exactly."""
    d2 = sum((Xm_rows[:, None, k] - Xm[None, :, k]) ** 2
             for k in range(Xm.shape[1]))
    s2 = theta[6] * theta[6]
    if row0 is None:
        return s2 * torch.exp(-torch.sqrt(d2)) + theta[8]
    r = Xm_rows.shape[0]
    diag = (torch.arange(r, device=d2.device)[:, None] + row0
            == torch.arange(Xm.shape[0], device=d2.device)[None, :])
    e = torch.where(diag, torch.ones_like(d2),
                    torch.exp(-torch.sqrt(torch.where(diag,
                                                      torch.ones_like(d2),
                                                      d2))))
    return s2 * e + theta[8] + theta[9] * diag.to(d2.dtype)


class Factor:
    """The lower tiles of A = L L^T, factored tile by tile."""

    def __init__(self, tiles, edges, prec: Prec):
        self.tiles, self.edges, self.prec = tiles, edges, prec
        self.n = edges[-1]

    @property
    def ok(self) -> bool:
        return self.tiles is not None

    def logdet(self) -> float:
        if not self.ok:
            return math.nan
        return float(sum(2.0 * torch.sum(torch.log(torch.diagonal(
            self.tiles[i, i].double()))) for i in range(len(self.edges) - 1)))

    def lower_solve(self, B: torch.Tensor) -> torch.Tensor:
        """L^-1 B by forward substitution over the tiles."""
        e, T, mm = self.edges, self.tiles, self.prec.mm
        Y = []
        for i in range(len(e) - 1):
            acc = B[e[i]:e[i + 1]].clone()
            for k in range(i):
                acc -= mm(T[i, k], Y[k])
            Y.append(torch.linalg.solve_triangular(T[i, i], acc,
                                                   upper=False))
        return torch.cat(Y)

    def upper_solve(self, Y: torch.Tensor) -> torch.Tensor:
        """L^-T Y by back substitution over the tiles."""
        e, T, mm = self.edges, self.tiles, self.prec.mm
        nb = len(e) - 1
        X = [None] * nb
        for i in reversed(range(nb)):
            acc = Y[e[i]:e[i + 1]].clone()
            for k in range(i + 1, nb):
                acc -= mm(T[k, i].T, X[k])
            X[i] = torch.linalg.solve_triangular(T[i, i].T, acc, upper=True)
        return torch.cat(X)

    def solve(self, B: torch.Tensor) -> torch.Tensor:
        """A^-1 B (NaN where the factor failed)."""
        if not self.ok:
            return torch.full_like(B, math.nan)
        return self.upper_solve(self.lower_solve(B))


def factor(Xs: torch.Tensor, theta: torch.Tensor, prec: Prec,
           tile: int) -> Factor:
    """Tiled right-looking Cholesky of A(theta) over the points Xs
    (standardized, (n, 3), in prec's dtype). A failed diagonal factor
    gives a Factor with no tiles."""
    n = Xs.shape[0]
    edges = list(range(0, n, tile)) + [n]
    nb = len(edges) - 1
    Xm = prec.mm(Xs, metric(theta))
    T = {}
    for j in range(nb):
        for i in range(j, nb):
            T[i, j] = gram(Xm[edges[i]:edges[i + 1]],
                           Xm[edges[j]:edges[j + 1]], theta,
                           edges[i] - edges[j])
    for k in range(nb):
        Lkk, info = torch.linalg.cholesky_ex(T[k, k])
        if int(info) != 0 or not bool(torch.isfinite(Lkk).all()):
            return Factor(None, edges, prec)
        T[k, k] = Lkk
        for i in range(k + 1, nb):
            T[i, k] = torch.linalg.solve_triangular(Lkk.T, T[i, k],
                                                    upper=True, left=False)
        for j in range(k + 1, nb):
            for i in range(j, nb):
                T[i, j] -= T[i, k] @ T[j, k].T
    return Factor(T, edges, prec)


def nlml(fac: Factor, y: torch.Tensor):
    """(NLML, alpha = A^-1 y) from the factor."""
    n = y.shape[0]
    alpha = fac.solve(y[:, None])[:, 0]
    val = 0.5 * float(torch.dot(y.double(), alpha.double())) \
        + 0.5 * fac.logdet() + 0.5 * n * math.log(2.0 * math.pi)
    return val, alpha


def contract_grad(Xs: torch.Tensor, theta: np.ndarray, weight: Callable,
                  prec: Prec, chunk: int) -> np.ndarray:
    """d/dtheta of 1/2 sum_ij W_ij A_ij(theta) with W fixed, `chunk` rows
    of A at a time: weight(A_rows, s, e) returns sum(W[s:e] * A_rows)."""
    th = torch.tensor(np.asarray(theta, np.float64), dtype=prec.dtype,
                      device=Xs.device, requires_grad=True)
    total = torch.zeros(N_HYPER, dtype=torch.float64, device=Xs.device)
    n = Xs.shape[0]
    with torch.enable_grad():
        for s in range(0, n, chunk):
            Xm = prec.mm(Xs, metric(th))
            e = min(n, s + chunk)
            val = 0.5 * weight(gram(Xm[s:e], Xm, th, s), s, e)
            (g,) = torch.autograd.grad(val, th)
            total += g.double()
    return total.cpu().numpy()


def grad_hutchinson(Xs, theta, alpha, Ws, Z: torch.Tensor, prec: Prec,
                    chunk: int) -> np.ndarray:
    """The gradient's Hutchinson estimate with the probes Z (n, m) and
    their exact solves Ws = A^-1 Z:
      1/2 (1/m) sum_k (A^-1 z_k)' dA z_k  -  1/2 alpha' dA alpha."""
    m = Z.shape[1]
    U = torch.cat([Ws, alpha[:, None]], 1)
    V = torch.cat([Z, alpha[:, None]], 1)
    c = torch.cat([torch.full((m,), 1.0 / m, dtype=U.dtype,
                              device=U.device),
                   torch.full((1,), -1.0, dtype=U.dtype, device=U.device)])

    def weight(A, s, e):
        return torch.sum(c * torch.sum(U[s:e] * prec.mm(A, V), dim=0))

    return contract_grad(Xs, theta, weight, prec, chunk)


def predict(Xs, theta, fac: Factor, alpha, Xq: torch.Tensor):
    """Posterior mean and variance (noise included) at the standardized
    queries Xq, the latent variance clamped at 0 before the noise."""
    th = torch.as_tensor(theta, dtype=Xs.dtype, device=Xs.device)
    M = metric(th)
    mm = fac.prec.mm
    kx = gram(mm(Xs, M), mm(Xq, M), th, None)           # (n, q)
    mu = mm(kx.T, alpha[:, None])[:, 0]
    v = fac.lower_solve(kx) if fac.ok else torch.full_like(kx, math.nan)
    kss = th[6] * th[6] + th[8]
    var = torch.clamp_min(kss - torch.sum(v * v, dim=0), 0.0) + th[9]
    return mu, var
