"""Pairwise-distance engines (port of gp_ss_ak_tpu/kernels/distance.py).

Re-design of the reference distance functions (`EuclDist`
Kernel.cpp:1343-1368, `MahaDist` Kernel.cpp:1370-1435, `mlA`
Kernel.cpp:1437-1441): recentre both point sets by their combined mean
(numerical conditioning only — distances are translation invariant),
optionally map through an anisotropic metric, then use the Gram
expansion ||a||^2 + ||b||^2 - 2 a.b with a clamp of tiny negative values
to zero. The expansion is kept (not the direct difference) so these
generic paths agree with the JAX package to round-off; the hand-written
CUDA kernel behind `gp_ss_ak_torch.ops.pairwise` computes the flagship
Gram by direct differences instead.

Float32 matrix products must run in full float32: see
`highest_precision` and the note in `gram_sqdist`.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def highest_precision():
    """Full-float32 matrix products (no TF32) inside the block.

    The JAX package wraps its dense algebra in
    `jax.default_matmul_precision("highest")` (gaussian.py:90); this is
    the same switch for torch, set explicitly rather than relying on
    the defaults, and restored on exit."""
    prev_prec = torch.get_float32_matmul_precision()
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
        torch.set_float32_matmul_precision(prev_prec)


def _recentre(X1: torch.Tensor, X2: torch.Tensor):
    """Subtract the combined mean of the stacked point sets from both.

    Mirrors the conditioning trick at Kernel.cpp:1354-1360 /
    1391-1397: m = (sum(X1) + sum(X2)) / (n + m) is removed from every
    point (UTM mining coordinates carry a large common offset).
    """
    n = X1.shape[0]
    m = X2.shape[0]
    c = (torch.sum(X1, dim=0) + torch.sum(X2, dim=0)) / (n + m)
    return X1 - c, X2 - c


def gram_sqdist(A1: torch.Tensor, A2: torch.Tensor,
                same: bool = False) -> torch.Tensor:
    """||a_i - b_j||^2 for every pair via the Gram expansion, clamped >= 0.

    The clamp mirrors Kernel.cpp:1366-1367 (float cancellation can give
    tiny negatives). The cross product must run in full float32:
    reduced precision (TF32, bf16) loses ~1e-2 absolute here, enough to
    make the Gram matrix indefinite and every downstream Cholesky NaN.
    With ``same=True`` (A1 is A2) the diagonal is set to exactly zero.
    Leading batch axes, (B, n, d) and (B, m, d), give (B, n, m).
    """
    s1 = torch.sum(A1 * A1, dim=-1, keepdim=True)  # (n, 1)
    s2 = torch.sum(A2 * A2, dim=-1, keepdim=True)  # (m, 1)
    cross = A1 @ A2.mT
    d2 = torch.clamp_min(s1 + s2.mT - 2.0 * cross, 0.0)
    if same:
        d2.diagonal(dim1=-2, dim2=-1).zero_()
    return d2


def sq_euclidean(X1: torch.Tensor, X2: torch.Tensor, hyp,
                 same: bool = False) -> torch.Tensor:
    """Scaled squared Euclidean distance, hyp^-2 * ||x - y||^2
    (`EuclDist`, Kernel.cpp:1343-1368, scale exp(-2 log hyp))."""
    X1c, X2c = _recentre(X1, X2)
    scale = torch.exp(-2.0 * torch.log(hyp))
    return scale * gram_sqdist(X1c, X2c, same)


def rotation_matrix_3d(alpha, beta, theta, dtype=None) -> torch.Tensor:
    """The reference's 3-D rotation R(alpha, beta, theta), element for
    element the matrix of Kernel.cpp:1402-1410."""
    ca, sa = torch.cos(alpha), torch.sin(alpha)
    cb, sb = torch.cos(beta), torch.sin(beta)
    ct, st = torch.cos(theta), torch.sin(theta)
    R = torch.stack(
        [
            torch.stack([ca * ct + sa * sb * st, -sa * ct + ca * sb * st, -cb * st]),
            torch.stack([sa * cb, ca * cb, sb]),
            torch.stack([ca * st - sa * sb * ct, -sa * st - ca * sb * ct, cb * ct]),
        ]
    )
    if dtype is not None:
        R = R.to(dtype)
    return R


def anisotropic_metric(params: dict, input_dim: int) -> torch.Tensor:
    """M = R diag(lambda) R^T for the ExpAns kernel (Kernel.cpp:1425-1427;
    the effective metric on distances is M^2 = R lambda^2 R^T).

      d <= 3 : inputs are zero-padded to 3 columns upstream;
      d == 4 : rock-type dimension gets lambda_3 = InversewidthR and an
               identity rotation block (Kernel.cpp:1411-1424);
      d > 4  : every extra dimension reuses InversewidthR.
    """
    d = max(int(input_dim), 3)
    angle = params["AngleX"]
    dtype, device = angle.dtype, angle.device
    R3 = rotation_matrix_3d(params["AngleX"], params["AngleY"],
                            params["AngleZ"], dtype)
    lam3 = torch.stack([params["inverseWidthx"], params["inverseWidthy"],
                        params["inverseWidthz"]]).to(dtype)
    M3 = (R3 * lam3[None, :]) @ R3.T
    if d == 3:
        return M3
    M = torch.zeros((d, d), dtype=dtype, device=device)
    M[:3, :3] = M3
    extra = torch.arange(3, d, device=device)
    M[extra, extra] = params["inversewidthR"].to(dtype)
    return M


def sq_mahalanobis(X1: torch.Tensor, X2: torch.Tensor, M: torch.Tensor,
                   same: bool = False) -> torch.Tensor:
    """Squared distance after mapping both sets through M (so metric M^2),
    `MahaDist` Kernel.cpp:1425-1434."""
    X1c, X2c = _recentre(X1, X2)
    return gram_sqdist(X1c @ M, X2c @ M, same)


def pad_to_3d(X: torch.Tensor) -> torch.Tensor:
    """Zero-pad trailing columns so the 3-D rotation metric applies to
    d < 3."""
    d = X.shape[-1]
    if d >= 3:
        return X
    return torch.nn.functional.pad(X, (0, 3 - d))


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt with a zero gradient at x == 0 (the reference zeroes the
    diagonal of dk/d(d2), Kernel.cpp:670-672); the double-where keeps
    autograd finite there."""
    positive = x > 0
    guarded = torch.where(positive, x, torch.ones_like(x))
    return torch.where(positive, torch.sqrt(guarded), torch.zeros_like(x))
