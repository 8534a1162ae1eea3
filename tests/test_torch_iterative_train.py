"""Port parity: the matrix-free training engine (inference/iterative.py,
ops/matvec.py's operators, optim/iterative_fit.py).

Probes: the JAX functions draw Rademacher probes from `jax.random` keys;
here the test draws the same matrices with `jax.random.rademacher` (as
the JAX function does from its key) and hands them to the port (`Z=`).

Two kinds of comparison, with their tolerances:
  * float64, one dense matrix A (numpy) as both packages' operator: CG,
    PCG and Woodbury run the same recurrences and differ only in the
    order of sums, so results agree to rtol 1e-10 (relative to each
    result's largest entry) with equal iteration counts. Plain CG uses a
    noisier operator (sn2 = 2, kappa ~ 30), as
    tests/test_torch_iterative.py explains. Lanczos carries float32 in
    both packages: see its test for its tolerances.
  * float32, the engines end to end (`nlml_iterative`, `grad_iterative`,
    `nlml_and_grad_iterative`, `make_iterative_value_and_grad`) on the
    flagship operator, the JAX side's Pallas kernels in interpret mode at
    n <= 256, tm = tn = 128. The packages sum in other orders, CG counts
    may differ by one iteration at float32 round-off, and the bias
    gradient (a sum over n^2 entries of mixed sign) cancels: held to the
    JAX package's own tolerances for two float32 modes of one estimator
    (tests/test_iterative.py:355-365): value rel 1e-4, abs 0.05; sigma,
    bias, sn2 gradients rel 1e-3, abs 1e-2; the Xm gradient within 1e-3
    of its largest entry; iteration counts within 1. The exact chol
    mode has no CG: its values agree to rel 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gp_ss_ak_tpu.model as jm
import gp_ss_ak_torch.model as tm
from gp_ss_ak_tpu.inference import iterative as ji
from gp_ss_ak_tpu.ops import matvec as jmv
from gp_ss_ak_tpu.ops.fused import mapped_points
from gp_ss_ak_tpu.optim.iterative_fit import (
    make_iterative_value_and_grad as j_make_vg,
)
from gp_ss_ak_torch.inference import iterative as ti
from gp_ss_ak_torch.ops import matvec as tmv
from gp_ss_ak_torch.optim.iterative_fit import (
    make_iterative_value_and_grad as t_make_vg,
)

RTOL = 1e-10
SIGMA, BIAS, SN2 = 0.9, 0.3, 0.016
SN2_CG = 2.0
TILE = dict(tm=128, tn=128)
CPU = torch.device("cpu")

# one intra-op thread per process: the suite runs on several workers at
# once, and torch's default (a thread per core in every worker)
# oversubscribes the cores and slows these small CPU ops many times over
torch.set_num_threads(1)


def close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def rademacher(key, shape):
    """The probe block the JAX functions draw from `key`, as a tensor."""
    return torch.tensor(np.asarray(jax.random.rademacher(key, shape,
                                                         jnp.float32)))


# --- float64, one dense matrix -------------------------------------------

def dense_case(n=160, b=3, seed=0, sn2=SN2):
    rng = np.random.default_rng(seed)
    X = 2.0 * rng.uniform(-1, 1, (n, 3))
    r = np.sqrt(((X[:, None, :] - X[None, :, :]) ** 2).sum(-1))
    A = SIGMA ** 2 * np.exp(-r) + BIAS + sn2 * np.eye(n)
    return X, A, rng.normal(size=(n, b))


def matmats(A):
    """Both packages' operator: A in float64; probes arrive in float32 in
    both and are promoted at the product."""
    Aj, At = jnp.asarray(A), torch.from_numpy(A.copy())
    return (lambda V: Aj @ V.astype(jnp.float64),
            lambda V: At @ V.to(torch.float64))


def test_cg_solve_matches_jax():
    _, A, B = dense_case(seed=1, sn2=SN2_CG)
    mj, mt = matmats(A)
    b = B[:, 0]
    xj, itj, rj = ji.cg_solve(mj, jnp.asarray(b), tol=1e-9, maxiter=500)
    xt, itt, rt = ti.cg_solve(mt, torch.from_numpy(b.copy()), tol=1e-9,
                              maxiter=500)
    assert itt == int(itj)
    close(xt.numpy(), xj)
    assert float(rt) == pytest.approx(float(rj), rel=1e-3)
    _, itc, _ = ti.cg_solve(mt, torch.from_numpy(b.copy()), tol=1e-9,
                            maxiter=3)
    assert itc == 3


def test_woodbury_and_pcg_match_jax():
    X, A, B = dense_case(seed=2)
    L = np.array(ji.pivoted_cholesky(jnp.asarray(X), SIGMA, BIAS, 30))
    Lj, Lt = jnp.asarray(L), torch.from_numpy(L)
    close(ti.woodbury_pieces(Lt, SN2).numpy(), ji.woodbury_pieces(Lj, SN2))
    pj, pt = ji.woodbury_preconditioner(Lj, SN2), \
        ti.woodbury_preconditioner(Lt, SN2)
    for v in (B, B[:, 0]):
        close(pt(torch.from_numpy(v.copy())).numpy(), pj(jnp.asarray(v)))
    P = L @ L.T + SN2 * np.eye(L.shape[0])
    close(pt(torch.from_numpy(P @ B)).numpy(), B, rtol=1e-7)
    mj, mt = matmats(A)
    b = B[:, 1]
    xj, itj, rj = ji.pcg_solve(mj, jnp.asarray(b), pj, tol=1e-9)
    xt, itt, rt = ti.pcg_solve(mt, torch.from_numpy(b.copy()), pt, tol=1e-9)
    assert itt == int(itj)
    close(xt.numpy(), xj, rtol=1e-8)
    tinv, tld = ti.precond_sqrt(Lt, SN2)
    jinv, jld = ji.precond_sqrt(Lj, SN2)
    close(tinv(torch.from_numpy(B)).numpy(), jinv(jnp.asarray(B)))
    assert float(tld) == pytest.approx(float(jld), rel=RTOL)
    assert ti.make_preconditioner(ti.IterativeGP(
        torch.from_numpy(X), SIGMA, BIAS, SN2), 0) is None


def test_lanczos_and_slq_match_jax():
    # Lanczos keeps its carry in the probes' float32 (JAX's scan needs
    # it), so the operator returns float32. Without reorthogonalization
    # the float32 coefficients past the top Ritz value's convergence are
    # round-off and drift apart between any two summation orders, while
    # the quadrature does not see them: at sn2 = 2 the SLQ values agree
    # to rel 1e-6, the first 3 steps' coefficients to 1e-5 of their
    # largest, and the quadrature of the SAME coefficients to 1e-6 (a
    # float32 k x k eigh in each framework)
    X, A, _ = dense_case(seed=3, sn2=SN2_CG)
    Aj, At = jnp.asarray(A), torch.from_numpy(A.copy())

    def mj(V):
        return (Aj @ V.astype(jnp.float64)).astype(V.dtype)

    def mt(V):
        return (At @ V.to(torch.float64)).to(V.dtype)

    n, k, m = A.shape[0], 12, 5
    key = jax.random.PRNGKey(7)
    # per-probe SLQ: JAX splits the key, one (n,) probe per split
    Z1 = torch.stack([rademacher(kk, (n,)) for kk in
                      jax.random.split(key, m)], 1)
    vj = ji.slq_logdet(lambda v: mj(v[:, None])[:, 0], n, key, m, k)
    vt = ti.slq_logdet(lambda v: mt(v[:, None])[:, 0], n, None, m, k, Z=Z1)
    assert float(vt) == pytest.approx(float(vj), rel=1e-6)
    aj, bj = ji._lanczos(lambda v: mj(v[:, None])[:, 0],
                         jnp.asarray(Z1[:, 0].numpy()), k)
    at, bt = ti._lanczos(lambda v: mt(v[:, None])[:, 0], Z1[:, 0], k)
    close(at[:3].numpy(), aj[:3], rtol=1e-5)
    close(bt[:3].numpy(), bj[:3], rtol=1e-5)
    # batched SLQ, its segments and its quadrature
    Z = rademacher(key, (n, m))
    vj = ji.slq_logdet_batched(mj, n, key, m, k)
    vt = ti.slq_logdet_batched(mt, n, None, m, k, Z=Z)
    assert float(vt) == pytest.approx(float(vj), rel=1e-6)
    aj, bj = ji._lanczos_batched(mj, jnp.asarray(Z.numpy()), k)
    carry = ti.lanczos_batched_init(Z)
    carry, a1, b1 = ti.lanczos_batched_segment(mt, carry, 5)
    carry, a2, b2 = ti.lanczos_batched_segment(mt, carry, k - 5)
    at, bt = torch.cat([a1, a2]), torch.cat([b1, b2])
    close(at[:3].numpy(), aj[:3], rtol=1e-5)
    close(bt[:3].numpy(), bj[:3], rtol=1e-5)
    at2, bt2 = ti._lanczos_batched(mt, Z, k)
    assert torch.equal(at2, at) and torch.equal(bt2, bt[:-1])
    assert float(ti.slq_quadrature(at, bt, n)) == pytest.approx(
        float(ji.slq_quadrature(jnp.asarray(at.numpy()),
                                jnp.asarray(bt.numpy()), n)), rel=1e-6)
    # a 5-probe estimate of the exact log det
    assert float(ti.slq_quadrature(at, bt, n)) == pytest.approx(
        np.linalg.slogdet(A)[1], rel=5e-2)
    # the preconditioned split at the flagship sn2: logdet P + SLQ on the
    # whitened operator, whose spectrum clusters at 1; its P^(-1/2) comes
    # from a float32 eigh of L^T L in each framework: rel 1e-5
    X, A, _ = dense_case(seed=3)
    Aj, At = jnp.asarray(A), torch.from_numpy(A.copy())
    L = np.array(ji.pivoted_cholesky(jnp.asarray(X), SIGMA, BIAS, 30),
                 np.float32)
    vj = ji.slq_logdet_preconditioned(mj, jnp.asarray(L), SN2, n, key, m, k)
    vt = ti.slq_logdet_preconditioned(mt, torch.from_numpy(L), SN2, n, None,
                                      m, k, Z=Z)
    assert float(vt) == pytest.approx(float(vj), rel=1e-5)
    assert float(vt) == pytest.approx(np.linalg.slogdet(A)[1], rel=2e-2)


def test_probe_matrix_shape_is_checked_and_keys_draw_rademacher():
    with pytest.raises(ValueError, match="probe matrix"):
        ti.slq_logdet_batched(lambda V: V, 10, None, 4, 3,
                              Z=torch.ones(10, 3))
    with pytest.raises(ValueError, match="Generator"):
        ti.slq_logdet_batched(lambda V: V, 10, None, 4, 3)
    g = torch.Generator().manual_seed(0)
    Z = ti.rademacher(g, (500, 4))
    assert Z.dtype == torch.float32 and set(Z.unique().tolist()) == {-1, 1}


def test_chunked_matvec_matches_jax():
    _, A, B = dense_case(n=96, seed=4)
    v = B[:, 0]
    Aj, At = jnp.asarray(A), torch.from_numpy(A.copy())
    yj = ji.chunked_matvec(
        lambda c: jax.lax.dynamic_slice_in_dim(Aj, c * 32, 32),
        jnp.asarray(v), 3)
    yt = ti.chunked_matvec(lambda c: At[c * 32:(c + 1) * 32],
                           torch.from_numpy(v.copy()), 3)
    close(yt.numpy(), yj)


@pytest.mark.parametrize("n", [1000, 20000, 32768, 40000, 49152, 60000])
def test_modes_resolve_as_jax_on_the_cpu(n):
    # the three thresholds (chol, gemm, gemm_bf16) are JAX's on the CPU;
    # auto never picks gemm_bf16, which is opt-in in both packages
    assert ti._mode_thresholds(None) == ji._mode_thresholds()
    assert ti._mode_thresholds(CPU) == ji._mode_thresholds()
    assert ti.choose_mode(n) == ji.choose_mode(n)
    assert ti.choose_mode(n, "auto", CPU) == ji.choose_mode(n)
    for mode in ("gemm", "stream", "chol", "gemm_bf16"):
        assert ti.choose_mode(n, mode) == ji.choose_mode(n, mode)
        for tol in (1e-6, 1e-2):
            assert ti._effective_cg_tol(tol, mode) \
                == ji._effective_cg_tol(tol, mode)
    with pytest.raises(ValueError):
        ti.choose_mode(n, "dense")


# --- float32, the flagship operator --------------------------------------

def flagship(n=192, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (n, 3))
    y = np.sin(X @ np.array([1.0, 2.0, 3.0]))
    m = jm.default_model(3, dtype=jnp.float32)
    ep, bp = m.kernel_params
    Xm = np.asarray(mapped_points(m.kernel.children[0], ep,
                                  jnp.asarray(X, jnp.float32)))
    s, b, sn2 = (float(ep["Sigma"]), float(bp["Sigma"]),
                 float(m.lik_hypers[0]))
    gj = ji.IterativeGP(jnp.asarray(Xm), jnp.float32(s), jnp.float32(b),
                        jnp.float32(sn2))
    gt = ti.IterativeGP(torch.tensor(Xm), torch.tensor(s), torch.tensor(b),
                        torch.tensor(sn2))
    return gj, gt, jnp.asarray(y, jnp.float32), torch.tensor(
        y, dtype=torch.float32), X, y


def grads_close(gt, gj):
    for a, c in zip(gt[:3], gj[:3]):
        assert float(a) == pytest.approx(float(c), rel=1e-3, abs=1e-2)
    close(gt[3].numpy(), gj[3], rtol=1e-3)


@pytest.mark.parametrize("n", [257, 300])
def test_operators_match_jax(n):
    gj, gt, *_ = flagship(n=n, seed=n)
    v = np.random.default_rng(n).normal(size=(n, 3)).astype(np.float32)
    opj = jmv.MatvecOperator(gj.Xm, gj.sigma, gj.bias, gj.sn2, **TILE)
    opt = tmv.MatvecOperator(gt.Xm, gt.sigma, gt.bias, gt.sn2)
    yj = np.asarray(opj(jnp.asarray(v[:, 0])))
    # float32 sums of n terms in other orders: within 1e-5 of max |y|
    close(opt(torch.from_numpy(v[:, 0])).numpy(), yj, rtol=1e-5)
    close(tmv.streamed_matvec_plain(opt.X, opt.scal, gt.bias, gt.sn2,
                                    torch.from_numpy(v[:, 0])).numpy(),
          yj, rtol=1e-5)
    close(opt.matmat(torch.from_numpy(v)).numpy(),
          opj.matmat(jnp.asarray(v)), rtol=1e-5)
    mj = jmv.MaterializedOperator(gj.Xm, gj.sigma, gj.bias, gj.sn2,
                                  interpret=True)
    mt = tmv.MaterializedOperator(gt.Xm, gt.sigma, gt.bias, gt.sn2)
    close(mt(torch.from_numpy(v[:, 0])).numpy(), mj(jnp.asarray(v[:, 0])),
          rtol=1e-5)
    close(mt.matmat(torch.from_numpy(v)).numpy(), mj.matmat(jnp.asarray(v)),
          rtol=1e-5)
    # the stored K has the exact s2 + bias diagonal; sn2 joins in float32
    e0 = torch.zeros(n)
    e0[0] = 1.0
    k00 = float(gt.sigma) ** 2 + float(gt.bias) + float(gt.sn2)
    assert float(mt(e0)[0]) == pytest.approx(k00, rel=1e-6)
    assert tmv.streamed_matvec_plain(opt.X, opt.scal, 0.0, 0.0, e0)[0] \
        == opt.scal[0]
    assert tmv.matvec_launches == 0       # the CPU never launches K2


@pytest.mark.parametrize("n", [257, 300])
def test_bf16_operator_matches_jax(n, monkeypatch):
    gj, gt, *_ = flagship(n=n, seed=n)
    v = np.random.default_rng(n).normal(size=(n, 3)).astype(np.float32)
    mj = jmv.MaterializedOperator(gj.Xm, gj.sigma, gj.bias, gj.sn2,
                                  store_dtype=jnp.bfloat16, interpret=True)
    mt = tmv.MaterializedOperator(gt.Xm, gt.sigma, gt.bias, gt.sn2,
                                  store_dtype=torch.bfloat16)
    assert mt.A.dtype == torch.bfloat16 and mt.A.shape == (n, n)
    # the stored K: the packages' float32 builds differ by an ulp here and
    # there, so a few entries round to the neighbouring bfloat16
    Aj = torch.from_numpy(np.asarray(mj.A, np.float32))
    At = mt.A.float()
    flips = (At != Aj)
    assert int(flips.sum()) <= 1e-3 * n * n
    assert float(torch.max(torch.where(flips, (At - Aj).abs() / Aj.abs(),
                                       0.0))) <= 2.0 ** -7
    # the product: V rounded to bfloat16 and accumulated in float32 in
    # both packages; on JAX's stored K, within 1e-5 of max |y|
    mt.A = Aj.bfloat16()
    close(mt.matmat(torch.from_numpy(v)).numpy(), mj.matmat(jnp.asarray(v)),
          rtol=1e-5)
    close(mt(torch.from_numpy(v[:, 0])).numpy(), mj(jnp.asarray(v[:, 0])),
          rtol=1e-5)
    mt.A = At.bfloat16()
    # the quantization error against the float32 store is JAX's
    # (tests/test_iterative.py:296-310 bounds it by 5e-3 for its data)
    vt, vj = torch.from_numpy(v[:, 0]), jnp.asarray(v[:, 0])
    f32t = tmv.MaterializedOperator(gt.Xm, gt.sigma, gt.bias, gt.sn2)
    f32j = jmv.MaterializedOperator(gj.Xm, gj.sigma, gj.bias, gj.sn2,
                                    interpret=True)
    rel_t = float(torch.linalg.norm(mt(vt) - f32t(vt))
                  / torch.linalg.norm(f32t(vt)))
    rel_j = float(jnp.linalg.norm(mj(vj) - f32j(vj))
                  / jnp.linalg.norm(f32j(vj)))
    assert rel_t == pytest.approx(rel_j, rel=1e-2) and rel_t < 2e-2
    # the build in row blocks (several K1 launches on the card) stores the
    # same bits as one block, the exact s2 + bias on the diagonal
    monkeypatch.setattr(tmv, "NARROW_BUILD_ELEMS", 40 * n)
    blocks = tmv.MaterializedOperator(gt.Xm, gt.sigma, gt.bias, gt.sn2,
                                      store_dtype=torch.bfloat16)
    assert torch.equal(blocks.A, mt.A)
    s2b = torch.tensor(float(gt.sigma) ** 2 + float(gt.bias)).bfloat16()
    assert torch.equal(blocks.A.diagonal(), s2b.expand(n))


@pytest.mark.parametrize("mode,rank", [("chol", 0), ("gemm", 0),
                                       ("stream", 0), ("gemm", 32),
                                       ("stream", 32)])
def test_nlml_iterative_matches_jax(mode, rank):
    gj, gt, yj, yt, *_ = flagship()
    key = jax.random.PRNGKey(3)
    kw = dict(cg_tol=1e-5, probes=8, lanczos_iters=16, precond_rank=rank,
              mode=mode)
    vj, aj, itj = ji.nlml_iterative(gj, yj, key, **TILE, **kw)
    Z = rademacher(key, (192, 8))
    vt, at, itt = ti.nlml_iterative(gt, yt, None, Z=Z, **kw)
    assert abs(itt - int(itj)) <= 1
    rel = 1e-5 if mode == "chol" else 1e-4
    assert float(vt) == pytest.approx(float(vj), rel=rel, abs=0.05)
    close(at.numpy(), aj, rtol=1e-4)


@pytest.mark.parametrize("mode,rank", [("chol", None), ("stream", 0),
                                       ("gemm", 32)])
def test_grad_iterative_matches_jax(mode, rank):
    gj, gt, yj, yt, *_ = flagship()
    key = jax.random.PRNGKey(4)
    kw = dict(probes=6, cg_tol=1e-6, cg_maxiter=2000, chunk=64,
              precond_rank=rank, mode=mode)
    g_j = ji.grad_iterative(gj, yj, key, **TILE, **kw)
    Z = rademacher(key, (192, 6))
    g_t = ti.grad_iterative(gt, yt, None, Z=Z, **kw)
    grads_close(g_t, g_j)
    # with alpha given, only the probes are solved
    alpha = torch.linalg.solve(
        tmv.MaterializedOperator(gt.Xm, gt.sigma, gt.bias, gt.sn2).A.double()
        + float(gt.sn2) * torch.eye(192, dtype=torch.float64),
        yt.double()).float()
    grads_close(ti.grad_iterative(gt, yt, None, alpha=alpha, Z=Z, **kw),
                g_j)


@pytest.mark.parametrize("mode,rank", [("chol", None), ("gemm", 0),
                                       ("stream", 0), ("stream", 32)])
def test_nlml_and_grad_iterative_matches_jax(mode, rank):
    gj, gt, yj, yt, *_ = flagship()
    k1, k2 = jax.random.PRNGKey(1), jax.random.PRNGKey(2)
    kw = dict(cg_tol=1e-5, probes=4, lanczos_iters=16, precond_rank=rank,
              mode=mode, chunk=64, slq_probes=8)
    vj, g_j, sj = ji.nlml_and_grad_iterative(gj, yj, k1, k2, **TILE, **kw)
    vt, g_t, st = ti.nlml_and_grad_iterative(
        gt, yt, None, None, Z_logdet=rademacher(k1, (192, 8)),
        Z_trace=rademacher(k2, (192, 4)), **kw)
    assert abs(st.cg_iters - int(sj.cg_iters)) <= 1
    assert float(vt) == pytest.approx(float(vj), rel=1e-4, abs=0.05)
    grads_close(g_t, g_j)
    close(st.alpha.numpy(), sj.alpha, rtol=1e-4)
    assert float(st.rel_residual) <= (0.0 if mode == "chol" else 1e-5)


@pytest.mark.parametrize("rank", [0, 32])
def test_gemm_bf16_mode_matches_jax(rank):
    """The opt-in bfloat16 store end to end. Both packages floor cg_tol
    at BF16_CG_TOL_FLOOR = 1e-3 and stop there. Held as two float32 modes
    (module docstring), except the bias gradient: a sum of n^2 terms of
    both signs, which at bfloat16 entries and 1e-3 residuals cancels to
    ~0.1 apart (measured 0.14 at n = 192): held within 0.3."""
    gj, gt, yj, yt, *_ = flagship()
    k1, k2 = jax.random.PRNGKey(1), jax.random.PRNGKey(2)
    kw = dict(cg_tol=1e-5, probes=4, lanczos_iters=16, precond_rank=rank,
              mode="gemm_bf16", chunk=64, slq_probes=8)
    vj, g_j, sj = ji.nlml_and_grad_iterative(gj, yj, k1, k2, **TILE, **kw)
    vt, g_t, st = ti.nlml_and_grad_iterative(
        gt, yt, None, None, Z_logdet=rademacher(k1, (192, 8)),
        Z_trace=rademacher(k2, (192, 4)), **kw)
    assert abs(st.cg_iters - int(sj.cg_iters)) <= 1
    for rel in (float(st.rel_residual), float(sj.rel_residual)):
        assert 1e-4 < rel <= ti.BF16_CG_TOL_FLOOR
    assert float(vt) == pytest.approx(float(vj), rel=1e-4, abs=0.05)
    for i in (0, 2):
        assert float(g_t[i]) == pytest.approx(float(g_j[i]), rel=1e-3,
                                              abs=1e-2)
    assert float(g_t[1]) == pytest.approx(float(g_j[1]), abs=0.3)
    close(g_t[3].numpy(), g_j[3], rtol=1e-3)


def test_chol_mode_nan_protocol():
    gj, gt, yj, yt, *_ = flagship(n=64)
    bad = gt._replace(sn2=torch.tensor(-5.0))
    val, grads, st = ti.nlml_and_grad_iterative(
        bad, yt, None, None, mode="chol", probes=2,
        Z_trace=torch.ones(64, 2))
    assert np.isnan(float(val))
    assert all(torch.isnan(g).any() for g in grads)


@pytest.mark.parametrize("mode,rank", [("chol", None), ("stream", 0)])
def test_make_iterative_value_and_grad_matches_jax(mode, rank):
    _, _, _, _, X, y = flagship(n=160, seed=5)
    mj = jm.default_model(3, dtype=jnp.float32)
    mt = tm.default_model(3, dtype=torch.float32, device=CPU)
    kw = dict(seed=3, probes=4, lanczos_iters=12, cg_tol=1e-5, chunk=64,
              precond_rank=rank, slq_probes=8, mode=mode)
    vg_j = j_make_vg(mj, X, y, **TILE, **kw)
    k_ld, k_tr = jax.random.split(jax.random.PRNGKey(3))
    vg_t = t_make_vg(mt, X, y, Z_logdet=rademacher(k_ld, (160, 8)),
                     Z_trace=rademacher(k_tr, (160, 4)), **kw)
    x = np.asarray(mj.pack(), np.float64) * 1.05
    vj, g_j = vg_j(x)
    vt, g_t = vg_t(x)
    assert vt == pytest.approx(vj, rel=1e-4, abs=0.05)
    np.testing.assert_allclose(g_t, g_j, rtol=1e-3,
                               atol=1e-3 * np.abs(g_j).max())
    assert abs(vg_t.last_cg_iters - vg_j.last_cg_iters) <= 1
    assert vg_t.precond_rank == vg_j.precond_rank
    assert g_t.dtype == np.float64 and g_t.shape == (10,)
    # the same probes on every call: the objective is deterministic
    assert vg_t(x)[0] == vt


def test_drawn_probes_are_fixed_per_fit():
    _, _, _, _, X, y = flagship(n=96, seed=6)
    mt = tm.default_model(3, dtype=torch.float32, device=CPU)
    vg = t_make_vg(mt, X, y, seed=0, probes=3, slq_probes=4, chunk=32,
                   lanczos_iters=8, mode="stream", precond_rank=16)
    x = mt.pack().numpy().astype(np.float64)
    assert vg(x)[0] == vg(x)[0]
    other = t_make_vg(mt, X, y, seed=1, probes=3, slq_probes=4, chunk=32,
                      lanczos_iters=8, mode="stream", precond_rank=16)
    assert other(x)[0] != vg(x)[0]
    with pytest.raises(ValueError, match="iterative engine"):
        t_make_vg(tm.default_model(3, kernel_names=["RBF"], device=CPU),
                  X, y)
