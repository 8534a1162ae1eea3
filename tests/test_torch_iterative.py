"""Port parity: the iterative solvers of the matrix-free server, float64.

Both packages get the same points, right-hand sides and the same dense
matrix A (numpy) as their matmat, so the only differences are the order
of the sums inside each framework's reductions and products. At float64
that keeps the pivoted Cholesky factor, the P^(-1/2) applies and the
solutions within rtol 1e-10 (relative to the largest entry of each
result), and the iteration counts and stall cut-offs identical.

Unpreconditioned CG amplifies those round-off differences with
kappa(A): at sn2 = 0.016 or 0.5 (kappa ~ 1e4 or ~ 1e2 here) two float64
runs drift apart by 1e-7 and an iteration or two. So the plain-CG
cases use a noisier operator (SN2_CG = 2, kappa ~ 30), and the
flagship sn2 is held through the whitened route (what the server
runs), whose operator is well conditioned at any sn2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gp_ss_ak_tpu.inference import iterative as ji
from gp_ss_ak_torch.inference import iterative as ti

RTOL = 1e-10
SIGMA, BIAS, SN2 = 0.9, 0.3, 0.016
SN2_CG = 2.0


def close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def case(n=200, b=3, seed=0, sn2=SN2):
    rng = np.random.default_rng(seed)
    X = 2.0 * rng.uniform(-1, 1, (n, 3))
    r = np.sqrt(((X[:, None, :] - X[None, :, :]) ** 2).sum(-1))
    A = SIGMA ** 2 * np.exp(-r) + BIAS + sn2 * np.eye(n)
    return X, A, rng.normal(size=(n, b))


def matmats(A):
    Aj, At = jnp.asarray(A), torch.from_numpy(A.copy())
    return (lambda V: Aj @ V), (lambda V: At @ V)


@pytest.mark.parametrize("rank", [1, 40, 200])
def test_pivoted_cholesky_matches_jax(rank):
    X, _, _ = case(seed=rank)
    Lj = np.asarray(ji.pivoted_cholesky(jnp.asarray(X), SIGMA, BIAS, rank))
    Lt = ti.pivoted_cholesky(torch.from_numpy(X), SIGMA, BIAS, rank)
    assert Lt.dtype == torch.float64 and tuple(Lt.shape) == (200, rank)
    # equal factors to 1e-10 imply the same pivot sequence: each column
    # is the kernel column of its pivot
    close(Lt.numpy(), Lj)
    if rank == 200:     # full rank: L L^T = K to round-off
        K = SIGMA ** 2 * np.exp(-np.sqrt(((X[:, None] - X[None]) ** 2
                                          ).sum(-1))) + BIAS
        close(Lt.numpy() @ Lt.numpy().T, K, rtol=1e-8)


def test_pivoted_cholesky_with_device_scalars():
    X, _, _ = case(n=50)
    Lf = ti.pivoted_cholesky(torch.from_numpy(X), SIGMA, BIAS, 10)
    f64 = torch.float64
    Lt = ti.pivoted_cholesky(torch.from_numpy(X),
                             torch.tensor(SIGMA, dtype=f64),
                             torch.tensor(BIAS, dtype=f64), 10)
    close(Lt.numpy(), Lf.numpy())


def test_precond_sqrt_apply_matches_jax():
    X, _, B = case(seed=3)
    L = np.array(ji.pivoted_cholesky(jnp.asarray(X), SIGMA, BIAS, 40))
    Qj, ej, ldj = ji.precond_sqrt_pieces(jnp.asarray(L), SN2)
    Qt, et, ldt = ti.precond_sqrt_pieces(torch.from_numpy(L), SN2)
    # eigh may pick other signs/bases: compare the applies, not Q
    for v in (B, B[:, 0]):
        close(ti.precond_sqrt_apply(Qt, et, SN2, torch.from_numpy(v)),
              ji.precond_sqrt_apply(Qj, ej, SN2, jnp.asarray(v)))
    close(et.numpy(), np.asarray(ej))
    assert float(ldt) == pytest.approx(float(ldj), rel=RTOL)
    # P^(-1/2) P P^(-1/2) = I
    P = L @ L.T + SN2 * np.eye(200)

    def w(v):
        return ti.precond_sqrt_apply(Qt, et, SN2, v)

    got = w(torch.from_numpy(P) @ w(torch.from_numpy(B)))
    close(got.numpy(), B, rtol=1e-8)


@pytest.mark.parametrize("tol", [1e-8, 1e-17], ids=["converge", "stall"])
@pytest.mark.parametrize("jacobi", [False, True], ids=["cg", "pcg"])
def test_bcg_solve_info_matches_jax(tol, jacobi):
    _, A, B = case(seed=5, sn2=SN2_CG)
    mj, mt = matmats(A)
    dj, dt = jnp.asarray(np.diag(A)), torch.from_numpy(np.diag(A).copy())
    pj = (lambda R: R / dj[:, None]) if jacobi else None
    pt = (lambda R: R / dt[:, None]) if jacobi else None
    maxiter = 5000
    Xj, itj, relj = ji.bcg_solve_info(mj, jnp.asarray(B), pj, tol=tol,
                                      maxiter=maxiter)
    Xt, itt, relt = ti.bcg_solve_info(mt, torch.from_numpy(B), pt, tol=tol,
                                      maxiter=maxiter)
    assert int(itt) == int(itj)
    if tol < 1e-16:     # below the float64 floor: the stall cut-off fired
        assert int(itt) < maxiter
    close(Xt.numpy(), np.asarray(Xj))
    close(Xt.numpy(), np.linalg.solve(A, B), rtol=1e-6)
    assert float(relt) == pytest.approx(float(relj), rel=1e-3, abs=1e-16)
    Xs, its = ti.bcg_solve(mt, torch.from_numpy(B), pt, tol=tol,
                           maxiter=maxiter)
    assert int(its) == int(itt) and torch.equal(Xs, Xt)


@pytest.mark.parametrize("tol", [1e-8, 1e-17], ids=["converge", "stall"])
def test_whitened_solve_info_matches_jax(tol):
    X, A, B = case(seed=6)
    L = np.array(ji.pivoted_cholesky(jnp.asarray(X), SIGMA, BIAS, 40))
    mj, mt = matmats(A)
    Xj, itj, relj, ldj, _ = ji.whitened_solve_info(
        mj, jnp.asarray(L), SN2, jnp.asarray(B), tol=tol, maxiter=2000)
    Xt, itt, relt, ldt, wmm = ti.whitened_solve_info(
        mt, torch.from_numpy(L), SN2, torch.from_numpy(B), tol=tol,
        maxiter=2000)
    assert int(itt) == int(itj)
    close(Xt.numpy(), np.asarray(Xj))
    assert float(ldt) == pytest.approx(float(ldj), rel=RTOL)
    assert float(relt) == pytest.approx(float(relj), rel=1e-3, abs=1e-16)
    assert tuple(wmm(torch.from_numpy(B)).shape) == B.shape


def test_segment_resume_is_bit_identical_and_done_matches():
    _, A, B = case(seed=7, sn2=SN2_CG)
    mj, mt = matmats(A)
    Bt = torch.from_numpy(B)
    state, thresh = ti.bcg_init(Bt, None, 1e-10)
    whole = ti.bcg_segment(mt, None, state, thresh, 1000)
    part = ti.bcg_segment(mt, None, state, thresh, 7)
    assert int(part[5]) == 7
    assert not bool(ti.bcg_done(part, thresh, pinv=None))
    part = ti.bcg_segment(mt, None, part, thresh, 1000)
    assert int(part[5]) == int(whole[5])
    for a, b in zip(part, whole):
        assert torch.equal(a, b)
    assert bool(ti.bcg_done(whole, thresh, pinv=None))
    sj, thj = ji.bcg_init(jnp.asarray(B), None, 1e-10)
    sj = ji.bcg_segment(mj, None, sj, thj, 7)
    assert bool(ji.bcg_done(sj, thj, pinv=None)) is False
    with pytest.raises(ValueError):
        ti.bcg_init(Bt, None, 1e-5, X0=Bt)


def test_warm_start_matches_jax():
    _, A, B = case(seed=8, sn2=SN2_CG)
    mj, mt = matmats(A)
    X0 = 0.5 * np.linalg.solve(A, B)
    R0 = B - A @ X0
    sj, thj = ji.bcg_init(jnp.asarray(B), None, 1e-9, jnp.asarray(X0),
                          jnp.asarray(R0))
    st, tht = ti.bcg_init(torch.from_numpy(B), None, 1e-9,
                          torch.from_numpy(X0), torch.from_numpy(R0))
    sj = ji.bcg_segment(mj, None, sj, thj, 500)
    st = ti.bcg_segment(mt, None, st, tht, 500)
    assert int(st[5]) == int(sj[5])
    close(st[6].numpy(), np.asarray(sj[6]))


@pytest.mark.parametrize("n", [10, 3072, 4096, 49152, 65536, 10 ** 6])
def test_auto_precond_rank_matches_jax(n):
    assert ti.auto_precond_rank(n) == ji.auto_precond_rank(n)
