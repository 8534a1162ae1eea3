"""Port parity: the streamed Gram matmat (K3) on the CPU.

The port's `streamed_matmat` runs its plain torch version on CPU tensors;
the JAX side runs the Pallas kernel in interpret mode (as
tests/test_iterative.py does). Both are float32 and both use the
|xi|^2 + |xj|^2 - 2 xi.xj expansion, but they sum K V in another order
(a row-chunked GEMM against 128 x 128 tiles), so they agree to rtol/atol
1e-4 on O(1) outputs: a few float32 ulps times the ~sqrt(n) growth of
the rounding of an n-term sum. Both are also held to the JAX test's own
2e-4 against a float64 dense A @ V.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gp_ss_ak_tpu.model import default_model
from gp_ss_ak_tpu.ops import matvec as jmatvec
from gp_ss_ak_tpu.ops.fused import mapped_points
from gp_ss_ak_torch.ops import matvec

RTOL = ATOL = 1e-4          # port vs JAX, float32
DENSE_TOL = 2e-4            # each vs float64 dense (test_iterative.py)


def operator_case(n, d, seed):
    """Mapped points of the default flagship model (f32), its sigma,
    bias and sn2, as numpy values for both packages."""
    rng = np.random.default_rng(seed)
    model = default_model(max(d, 3), dtype=jnp.float32)
    ep, bp = model.kernel_params
    X = rng.uniform(-1, 1, (n, max(d, 3))).astype(np.float32)
    Xm = np.asarray(mapped_points(model.kernel.children[0], ep,
                                  jnp.asarray(X)))[:, :d]
    return (np.array(Xm, np.float32), float(ep["Sigma"]),
            float(bp["Sigma"]), float(model.lik_hypers[0]))


def dense_A(Xm, sigma, bias, sn2):
    X = Xm.astype(np.float64)
    r = np.sqrt(((X[:, None, :] - X[None, :, :]) ** 2).sum(-1))
    A = sigma * sigma * np.exp(-r) + bias
    A[np.diag_indices_from(A)] = sigma * sigma + bias + sn2
    return A


def jax_matmat(Xm, sigma, bias, sn2, V):
    Xt, norms, scal = jmatvec.operator_arrays(jnp.asarray(Xm), sigma, 128)
    return np.asarray(jmatvec.streamed_matmat(
        Xt, norms, scal, bias, sn2, jnp.asarray(V), Xm.shape[0], 128, 128,
        True))


@pytest.mark.parametrize("n,b,d", [(300, 5, 3), (300, 1, 3), (257, 7, 3),
                                   (300, 5, 2), (130, 3, 4)])
def test_plain_matmat_matches_pallas_interpret(n, b, d):
    Xm, sigma, bias, sn2 = operator_case(n, d, seed=n + b + d)
    V = np.random.default_rng(b).normal(size=(n, b)).astype(np.float32)
    Yj = jax_matmat(Xm, sigma, bias, sn2, V)
    X_t, scal = matvec.operator_arrays(torch.from_numpy(Xm), sigma)
    before = matvec.launches
    Yt = matvec.streamed_matmat(X_t, scal, bias, sn2, torch.from_numpy(V))
    assert matvec.launches == before       # CPU tensors never launch
    assert Yt.dtype == torch.float32 and tuple(Yt.shape) == (n, b)
    np.testing.assert_allclose(Yt.numpy(), Yj, rtol=RTOL, atol=ATOL)
    ref = dense_A(Xm, sigma, bias, sn2) @ V.astype(np.float64)
    np.testing.assert_allclose(Yt.numpy(), ref, rtol=DENSE_TOL,
                               atol=DENSE_TOL)
    np.testing.assert_allclose(Yj, ref, rtol=DENSE_TOL, atol=DENSE_TOL)


def test_operator_arrays_shapes_and_scale():
    Xm, sigma, _, _ = operator_case(20, 3, seed=1)
    X_t, scal = matvec.operator_arrays(torch.from_numpy(Xm).double(),
                                       torch.tensor(sigma))
    assert X_t.dtype == torch.float32 and X_t.is_contiguous()
    assert tuple(X_t.shape) == (20, 4)          # features padded to 4
    assert torch.equal(X_t[:, :3], torch.from_numpy(Xm))
    assert not X_t[:, 3].any()
    with pytest.raises(ValueError):
        matvec.operator_arrays(torch.zeros(2, matvec.MAX_FEATURES + 1), 1.0)
    np.testing.assert_allclose(scal.numpy(), [sigma * sigma], rtol=1e-6)


@pytest.mark.parametrize("chunk", [7, 64, 4096])
def test_plain_chunking_is_invisible(chunk, monkeypatch):
    # the plain version's row chunks change nothing but memory: float64,
    # held to the dense product to round-off, the diagonal exact
    monkeypatch.setattr(matvec, "PLAIN_CHUNK", chunk)
    Xm, sigma, bias, sn2 = operator_case(150, 3, seed=2)
    V = np.random.default_rng(3).normal(size=(150, 4))
    X_t, scal = matvec.operator_arrays(torch.from_numpy(Xm), sigma)
    Y = matvec.streamed_matmat_plain(X_t.double(), scal.double(), bias, sn2,
                                     torch.from_numpy(V))
    ref = dense_A(Xm, sigma, bias, sn2) @ V
    # the expansion leaves ~1e-8 absolute round-off in K off the diagonal
    np.testing.assert_allclose(Y.numpy(), ref, rtol=1e-6, atol=1e-6)
    e0 = np.zeros((150, 1))
    e0[17] = 1.0
    col = matvec.streamed_matmat_plain(X_t.double(), scal.double(), 0.0,
                                       0.0, torch.from_numpy(e0))[:, 0]
    assert col[17].item() == float(scal.double()[0])    # exactly s^2


def test_rejects_other_devices():
    X_t, scal = matvec.operator_arrays(torch.zeros(4, 3), 1.0)
    with pytest.raises(ValueError):
        matvec.streamed_matmat(X_t.to("meta"), scal.to("meta"), 0.0, 0.0,
                               torch.zeros(4, 1, device="meta"))


# --- K3's tile routes: the wrapper's choice from B, pure Python ---

@pytest.mark.parametrize("b,route,width", [
    (1, "register", 1), (2, "register", 2), (3, "register", 4),
    (5, "register", 8), (8, "register", 8), (9, "register", 9),
    (10, "register", 12), (13, "register", 16), (17, "register", 24),
    (25, "register", 32), (32, "register", 32), (33, "register", 24),
    (48, "register", 24), (49, "register", 32), (64, "register", 32),
    (65, "wide", 0), (256, "wide", 0), (1024, "wide", 0)])
def test_matmat_route_by_width(b, route, width):
    assert matvec.matmat_route(b) == (route, width)


def test_register_routes_hold_b_in_the_narrowest_tiles():
    # every B <= 64 runs in one or two column groups of a register width;
    # a narrower width would not hold it in as many groups; the main
    # path's B = 1, 9, 32 and 64 mask no column
    widths = matvec.REGISTER_WIDTHS
    for b in range(1, 65):
        route, w = matvec.matmat_route(b)
        groups = -(-b // w)
        assert route == "register" and w in widths
        assert groups == (1 if b <= widths[-1] else 2)
        assert all(-(-b // v) > groups for v in widths if v < w)
    for b in (1, 9, 32, 64):
        _, w = matvec.matmat_route(b)
        assert b % w == 0


class _FakeLib:
    """Stands in for the kernel library: records each K3 launch."""

    def __init__(self):
        self.calls = []

    def gp_matmat_f32(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("b", [1, 9, 32, 64, 65, 1024])
def test_each_launch_counts_once_on_its_route(b, monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(matvec._build, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(matvec, "launches", 0)
    monkeypatch.setattr(matvec, "route_launches",
                        {"register": 0, "wide": 0})
    X, scal = matvec.operator_arrays(torch.rand(20, 3), 0.7)
    V = torch.rand(20, b)
    route, width = matvec.matmat_route(b)
    for k in range(1, 4):
        matvec._launch(X, scal, V, 3)
        assert matvec.launches == k
        assert matvec.route_launches == {
            r: (k if r == route else 0) for r in ("register", "wide")}
    # each launch is told the register width (0: the wide tile) and the
    # true feature count beside the padded one
    n, bb, dp, d, w = lib.calls[-1][4:9]
    assert (n, bb, dp, d, w) == (20, b, 4, 3, width)
    assert len(lib.calls) == 3


def test_matmat_d_is_checked_before_the_device_dispatch():
    X, scal = matvec.operator_arrays(torch.rand(6, 3), 0.7)
    V = torch.ones(6, 2)
    with pytest.raises(ValueError):
        matvec.streamed_matmat(X, scal, 0.1, 0.01, V, 5)
    with pytest.raises(TypeError):
        matvec.streamed_matmat(X, scal, 0.1, 0.01, V, 3.0)
    Y = matvec.streamed_matmat(X, scal, 0.1, 0.01, V, 3)
    assert torch.equal(Y, matvec.streamed_matmat(X, scal, 0.1, 0.01, V))
