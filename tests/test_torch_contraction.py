"""The gradient's contraction against dA/dtheta (ops/contraction.py and
inference/iterative.py's `_grad_contraction`) on the CPU, where the plain
closed-form version stands in for the CUDA kernel K4.

Two kinds of comparison, with their tolerances:
  * float64, the closed form against torch.autograd through a dense
    A = s2 exp(-r) + bias + sn2 I built the autograd version's way
    (clamp_min(d2, 1e-30), exact diagonal): the same numbers by two
    routes, to rtol 1e-10 of each result's largest entry.
  * float32, the port's `_grad_contraction` against the JAX package's
    (jax.grad through its chunked row build) on the same inputs, and
    both against the float64 autograd gradient of those inputs. The
    plain version, like the JAX package, squares distances by the
    |xp|^2 + |xj|^2 - 2 xp.xj expansion and sums g as
    xp sum f - sum f xj (on the card K4 takes direct differences), so
    that CPU fits take the JAX package's path; each side sums ~n^2
    float32 terms of mixed sign in its own order. At d = 2 and 3 both
    sit within 3e-6 of float64 and within 5e-6 of each other, held to
    TOL = 2e-5 (sigma, bias, sn2 relative; Xm of its largest entry).
    On 1-D points (spacing 3e-3 over [-1.5, 1.5] at n = 1000) the
    expansion's round-off (~1e-7 |x|^2) is a few percent of the closest
    pairs' d2: each side's Xm gradient is 1.6e-4 (n = 300) to 1.5e-3
    (n = 1000) of its largest entry from float64, and the two differ by
    up to 1.0e-3; there Xm is held to TOL_XM_1D = 4e-3. The points sit
    on a jittered lattice (no two closer than two thirds of its
    spacing), plus one exact duplicate pair at dyadic coordinates, where
    both sides' d2 is exactly 0 and the pair adds nothing to the Xm
    gradient.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gp_ss_ak_tpu.inference import iterative as ji
from gp_ss_ak_torch.inference import iterative as ti
from gp_ss_ak_torch.ops import contraction

SIGMA, BIAS, SN2 = 0.9, 0.3, 0.016
TOL = 2e-5
TOL_XM_1D = 4e-3
TOL_F64 = 1e-10

# one intra-op thread per process: the suite runs on several workers
torch.set_num_threads(1)


def lattice_points(n, d, seed):
    """n points of a jittered lattice over about [-1.5, 1.5]^d (each
    point within a sixth of the spacing of its cell's centre), points 3
    and 7 replaced by one dyadic point, float32."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(n ** (1.0 / d)))
    h = 3.0 / side
    cells = rng.choice(side ** d, size=n, replace=False)
    idx = np.stack(np.unravel_index(cells, (side,) * d), axis=1)
    X = (idx + 0.5 + rng.uniform(-1 / 6, 1 / 6, (n, d))) * h - 1.5
    X[3] = X[7] = np.resize([0.5, -0.25, 0.125], d)
    return X.astype(np.float32)


def inputs(n, d, probes, seed):
    rng = np.random.default_rng(seed + 1)
    X = lattice_points(n, d, seed)
    alpha = rng.normal(size=n).astype(np.float32)
    ws = (3.0 * rng.normal(size=(probes, n))).astype(np.float32)
    zs = rng.choice([-1.0, 1.0], size=(probes, n)).astype(np.float32)
    return X, alpha, ws, zs


def port_gp(X, dtype=torch.float32):
    t = lambda v: torch.tensor(v, dtype=dtype)          # noqa: E731
    return ti.IterativeGP(torch.tensor(X, dtype=dtype), t(SIGMA), t(BIAS),
                          t(SN2))


def assert_grads_close(got, want, tol):
    for a, b in zip(got[:3], want[:3]):
        assert float(a) == pytest.approx(float(b), rel=tol)
    if len(want) < 4:
        return
    want_x = np.asarray(want[3], dtype=np.float64)
    np.testing.assert_allclose(np.asarray(got[3], dtype=np.float64), want_x,
                               rtol=tol, atol=tol * np.abs(want_x).max())


@pytest.mark.parametrize("probes", [8, 16])
@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("n", [300, 1000])
def test_closed_form_matches_jax(n, d, probes):
    X, alpha, ws, zs = inputs(n, d, probes, seed=10 * n + d)
    gj = ji.IterativeGP(jnp.asarray(X), jnp.float32(SIGMA),
                        jnp.float32(BIAS), jnp.float32(SN2))
    jax_g = ji._grad_contraction(gj, jnp.asarray(alpha), jnp.asarray(ws),
                                 jnp.asarray(zs), 128)
    before = contraction.launches
    got = ti._grad_contraction(port_gp(X), torch.tensor(alpha),
                               torch.tensor(ws), torch.tensor(zs), 128)
    assert all(g.dtype == torch.float32 for g in got)
    assert got[3].shape == (n, d)
    assert contraction.launches == before   # the CPU never launches K4
    ref = autograd_grads(*(torch.tensor(a, dtype=torch.float64)
                           for a in (X, alpha, ws, zs)))
    ref = [r.numpy() for r in ref]
    got = [g.numpy().astype(np.float64) for g in got]
    jax_g = [np.asarray(j, dtype=np.float64) for j in jax_g]
    for want in (jax_g, ref):
        assert_grads_close(got[:3], want[:3], TOL)
        tol = TOL_XM_1D if d == 1 else TOL
        assert np.abs(got[3] - want[3]).max() \
            <= tol * np.abs(want[3]).max()


def autograd_grads(X, alpha, ws, zs):
    """d/d(sigma, bias, sn2, Xm) of 1/2 sum_j c_j U[:,j]' A V[:,j] in
    float64 through a dense A, the autograd version's function."""
    f64 = torch.float64
    n = X.shape[0]
    m = ws.shape[0]
    U = torch.cat([ws.T, alpha[:, None]], 1).to(f64)
    V = torch.cat([zs.T, alpha[:, None]], 1).to(f64)
    coef = torch.tensor([1.0 / m] * m + [-1.0], dtype=f64)
    leaves = [torch.tensor(v, dtype=f64, requires_grad=True)
              for v in (SIGMA, BIAS, SN2)]
    Xm = X.detach().to(f64, copy=True).requires_grad_()
    sigma, bias, sn2 = leaves
    diff = Xm[:, None, :] - Xm[None, :, :]
    d2 = torch.sum(diff * diff, dim=-1)
    eye = torch.eye(n, dtype=torch.bool)
    r = torch.sqrt(torch.where(eye, 1.0, torch.clamp_min(d2, 1e-30)))
    A = sigma * sigma * torch.where(eye, 1.0, torch.exp(-r)) + bias \
        + sn2 * eye
    val = 0.5 * torch.dot(torch.sum(U * (A @ V), dim=0), coef)
    return torch.autograd.grad(val, [*leaves, Xm])


@pytest.mark.parametrize("n,d,probes", [(61, 1, 8), (61, 3, 16),
                                        (40, 5, 8), (50, 3, 40)],
                         ids=["d1", "d3", "d5", "rank41"])
def test_closed_form_is_the_gradient_in_float64(n, d, probes):
    """The closed form (duplicates included, and a rank past MAX_RANK,
    which `_grad_contraction` splits into column groups) against
    autograd through the dense A, in float64."""
    X, alpha, ws, zs = (torch.tensor(a, dtype=torch.float64)
                        for a in inputs(n, d, probes, seed=n + d))
    X[11] = X[5]                    # a second duplicate, not dyadic
    want = autograd_grads(X, alpha, ws, zs)
    U = torch.cat([ws.T, alpha[:, None]], 1)
    V = torch.cat([zs.T, alpha[:, None]], 1)
    coef = torch.tensor([1.0 / probes] * probes + [-1.0],
                        dtype=torch.float64)
    t, g = contraction.expans_contraction(X, U * coef, V, chunk=7)
    got = (SIGMA * t.sum(), 0.5 * torch.dot((U * coef).sum(0), V.sum(0)),
           0.5 * torch.sum(U * coef * V), -0.5 * SIGMA ** 2 * g)
    assert_grads_close([x.detach().numpy() for x in got],
                       [x.numpy() for x in want], TOL_F64)
    for i in (3, 5, 7, 11):         # duplicates: no nan, no inf
        assert torch.all(torch.isfinite(g[i]))
    # the float32 route through `_grad_contraction`, column groups and all
    got32 = ti._grad_contraction(port_gp(X.numpy()), alpha.float(),
                                 ws.float(), zs.float(), 16)
    assert_grads_close([x.numpy() for x in got32],
                       [x.numpy() for x in want], TOL)


def test_pairs_closer_than_the_threshold_add_nothing_to_g():
    """Two points 1e-16 apart (d2 = 1e-32 < 1e-30) add W to t, as the
    diagonal does, and nothing to g."""
    X = torch.tensor([[0.0, 0.0, 0.0], [1e-16, 0.0, 0.0], [1.0, 0.5, 0.0]],
                     dtype=torch.float64)
    cU = torch.tensor([[1.0], [2.0], [0.0]], dtype=torch.float64)
    V = torch.tensor([[3.0], [5.0], [0.0]], dtype=torch.float64)
    t, g = contraction.expans_contraction(X, cU, V)
    assert float(t[0]) == pytest.approx(1.0 * 3.0 + 1.0 * 5.0, rel=1e-14)
    assert torch.all(g[:2] == 0.0)


@pytest.mark.parametrize("n", [1, 63, 64, 4097, 20000, 100000])
def test_column_slices_cover_each_column_once(n):
    for rows, wave in ((512, 396), (256, 396), (128, 264)):
        width, slices = contraction.contraction_slices(n, rows, 64, wave)
        assert width % 64 == 0 and width <= contraction.MAX_SLICE
        assert 1 <= slices <= 65535
        assert (slices - 1) * width < n <= slices * width


def test_padded_rank():
    assert [contraction.padded_rank(k) for k in (1, 9, 10, 17, 18, 33)] \
        == [9, 9, 17, 17, 33, 33]
    with pytest.raises(ValueError):
        contraction.padded_rank(34)
